"""Smoke run of the PyTorch/CUDA port (``thetis_tpu_torch``) on one GPU.

Drives the port's two ported ``bench.py`` workloads through the
hand-written CUDA kernels, after building them from
``thetis_tpu_torch/csrc`` and holding each against its plain PyTorch
version:

* the 3D baroclinic channel (``bench.py::build_workload_3d``: periodic
  48x48 mesh, 4,608 columns x 12 layers, 1,036,800 DOF, SSPRK22 ALE,
  f32), which runs the tridiagonal kernel (2 launches per step) and, in
  its barotropic CN solve, the ring matvec and block-Jacobi kernels;
* the 2D semi-implicit CrankNicolson step (the CN workload: 320x160
  rectangle, 102,400 cells, 921,600 DOF, f32): ring matvec and
  block-Jacobi.

Phases, each printing its lines:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: one nvcc per kernel source, all started together, with seconds;
3. kernels against plain, f64 and f32, with times (CUDA events, median
   of 50): ring_mv, tridiag, block_diag_mv at the workloads' shapes;
4. 2D slice: 1 warm-up + 10 timed f32 CN steps, launch counts, rates;
5. 2D parity: one f64 step on the GPU (kernels) against the same step on
   the CPU (the port's plain path);
6. 3D slice: 1 warm-up + 20 timed f32 steps (the bench's n), launches per
   step, rates, peak memory, a per-phase and a profiler breakdown;
7. 3D parity: one f64 step on the GPU against the CPU plain path.

Then one JSON line describing each kernel, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result;
without a CUDA device it exits 1 at once.  Run from the repository root:
``python3 chip_smoke.py``.
"""
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from thetis_tpu_torch.config import physical_constants
from thetis_tpu_torch.equations.shallowwater_2d import (
    ShallowWaterEquations, swe_state)
from thetis_tpu_torch.fem.assembly import DGAssembler
from thetis_tpu_torch.fem.functionspace import Function, FunctionSpace
from thetis_tpu_torch.kernels import ringmv, tridiag
from thetis_tpu_torch.mesh.generation import (PeriodicRectangleMesh,
                                              RectangleMesh)
from thetis_tpu_torch.model.flowsolver3d import FlowSolver
from thetis_tpu_torch.solvers.assembled import ring_tables
from thetis_tpu_torch.solvers.newton import NewtonParameters
from thetis_tpu_torch.timeintegration.steppers import get_stepper
from thetis_tpu_torch.utils.coordsys import beta_plane_coriolis_params

NX, NY, LX, LY = 320, 160, 100e3, 50e3  # bench.py:213-214, :51
RESTART = 8
NX3, NY3, NZ3 = 48, 48, 12              # bench.py:206
L3, DEPTH3 = 1600e3, 1600.0             # bench.py:122-123
STEPS3 = 20                             # bench.py:207
RESTART3 = 6                            # flowsolver3d's barotropic solve
H100_BW = 3.35e12  # bytes/s, H100 SXM data sheet
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# one f64 step, GPU kernels vs CPU plain path: same Krylov path, sums in
# other orders; the solve amplifies 1e-16 roundoff by its conditioning
PARITY_RTOL = 1e-9
KERNELS = ("ring_mv", "tridiag", "block_diag_mv")
SOURCES = {"ring_mv": ("thetis_tpu_torch/csrc/ring_mv.cu",
                       "thetis_tpu/kernels/ringmv.py:45"),
           "tridiag": ("thetis_tpu_torch/csrc/tridiag.cu",
                       "thetis_tpu/kernels/tridiag.py:61"),
           "block_diag_mv": ("thetis_tpu_torch/csrc/block_diag_mv.cu",
                             "thetis_tpu/kernels/ringmv.py:59")}


def log(*a):
    print(*a, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, reps=50, warm=5):
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[reps // 2]


def device_rows(fn):
    """Run ``fn`` under torch.profiler; returns ``(us, count, name)`` of
    every device kernel, largest device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host ops; their kernels are rows of their own
        us = getattr(e, "self_device_time_total", None)
        rows.append((e.self_cuda_time_total if us is None else us, e.count,
                     e.key))
    return sorted(rows, reverse=True)


def device_ms(fn, reps=20):
    """Device time per call: the device kernels' time over ``reps`` calls,
    without the host's gaps between launches (which the CUDA-event time
    of :func:`median_ms` includes)."""
    fn()
    rows = device_rows(lambda: [fn() for _ in range(reps)])
    return sum(r[0] for r in rows) / reps / 1e3


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def reset_counts():
    ringmv.reset_launches()
    tridiag.reset_launches()


def counts():
    return {"ring_mv": ringmv.launches("ring_mv"),
            "tridiag": tridiag.launches(),
            "block_diag_mv": ringmv.launches("block_diag_mv")}


# -- workloads ----------------------------------------------------------
def workload(device, dtype, nx=NX, ny=NY):
    """The bench's CN case (bench.py:39-109) on the port."""
    mesh = RectangleMesh(nx, ny, LX, LY, device=device, dtype=dtype)
    V = FunctionSpace(mesh, "DG", 1)
    asm = DGAssembler(mesh, V)
    opts = SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)
    eq = ShallowWaterEquations(mesh, asm, opts, bathymetry=50.0,
                               bnd_conditions={})
    elev0 = Function(V).interpolate(
        lambda x, y: 1.0 * torch.exp(-(((x - LX / 2) / 15e3) ** 2)
                                     - ((y - LY / 2) / 15e3) ** 2))
    sol = swe_state(torch.zeros((mesh.nc, 3, 2), dtype=dtype, device=device),
                    elev0.data)
    fields = {
        "lax_friedrichs_velocity_scaling_factor": asm.as_tensor(1.0),
        "quadratic_drag_coefficient": asm.as_tensor(2.5e-3),
    }
    dt = 2.0 * float(mesh.cell_hmin_np.min()) / math.sqrt(9.81 * 51.0)
    st = get_stepper(
        "CrankNicolson", eq, dt, semi_implicit=True, assembled_solve=True,
        solver_parameters=NewtonParameters(ksp_rtol=1e-5, ksp_max_it=32,
                                           gmres_restart=RESTART))
    return mesh, eq, st, sol, fields


def workload3d(device, dtype, nx=NX3, ny=NY3, nz=NZ3):
    """The bench's 3D baroclinic channel (bench.py:112-177) on the port,
    entered as the bench enters the reference."""
    physical_constants["rho0"] = 1020.0
    mesh2d = PeriodicRectangleMesh(nx, ny, L3, L3, direction="x",
                                   device=device, dtype=dtype)
    nu_scale = 0.5 * (L3 / nx) / 200.0
    f0, beta = beta_plane_coriolis_params(37.5)
    cor = f0 + beta * (mesh2d.coords_np[:, 1] - L3 / 2)  # CG1 field
    s = FlowSolver(mesh2d, torch.tensor(DEPTH3, dtype=dtype, device=device),
                   nz)
    s.options.update(dict(
        timestepper_type="SSPRK22",
        solve_salinity=False,
        solve_temperature=True,
        constant_salinity=35.0,
        use_baroclinic_formulation=True,
        use_implicit_vertical_diffusion=True,
        use_bottom_friction=True,
        coriolis_frequency=torch.as_tensor(cor, dtype=dtype, device=device),
        vertical_viscosity=1e-3,
        vertical_diffusivity=1e-5,
        horizontal_viscosity=nu_scale,
        horizontal_diffusivity=30.0,
        equation_of_state_type="linear",
        timestep=300.0,
        simulation_export_time=24 * 3600.0,
        simulation_end_time=24 * 3600.0,
    ))
    s.initialize()
    x = mesh2d.coords_np[mesh2d.cells_np]  # (nc, 3, 2) P1DG nodes
    y_pert = 0.1 * L3 * np.sin(2 * np.pi * x[..., 0] / L3)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L3 / 2)
    sigma = np.linspace(-DEPTH3, 0.0, nz + 1)
    z_nodes = np.stack([sigma[:-1], sigma[1:]], axis=-1)
    temp0 = t2d[:, :, None, None] + 8.2e-3 * (z_nodes[None, None]
                                              + DEPTH3 / 2)
    s.assign_initial_conditions(
        elev=torch.zeros((mesh2d.nc, 3), dtype=dtype, device=device),
        temp=torch.as_tensor(temp0, dtype=dtype, device=device))
    n_dofs = 3 * (mesh2d.nc * 3 * nz * 2) + 3 * (mesh2d.nc * 3)
    return s, s._get_state(), s._gather_swe_fields(), n_dofs


# -- phases -------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32}")
    return name


def phase_build():
    from thetis_tpu_torch.config import BUILD_DIR
    from thetis_tpu_torch.kernels.build import build_libraries

    t0 = time.perf_counter()
    secs = build_libraries(KERNELS)
    each = ", ".join(f"{k}.cu {v:.2f} s" for k, v in secs.items())
    log(f"[build] {each}; all three in parallel "
        f"{time.perf_counter() - t0:.2f} s -> {BUILD_DIR} (nvcc -gencode "
        "arch=compute_90a,code=sm_90a)")


def check_kernel(tag, dtype, got, ref, fn, plain, nbytes):
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_TOL[dtype]
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    ms = median_ms(fn)
    plain_ms = median_ms(plain)
    dev_ms = device_ms(fn)
    plain_dev_ms = device_ms(plain)
    log(f"[kernel] {tag} {str(dtype)[6:]}: max|err|={err:.3e} (tol {tol:g} "
        f"x max|ref|={scale:.3e}) {'ok' if ok else 'FAIL'}; per call, "
        f"events (launch included) kernel {ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms; device time kernel {dev_ms:.4f} ms, plain {plain_dev_ms:.4f}"
        f" ms; bytes/call {nbytes / 1e6:.2f} MB -> bound "
        f"{nbytes / H100_BW * 1e3:.4f} ms at 3.35 TB/s, kernel device time "
        f"at {nbytes / max(dev_ms, 1e-9) / 1e6:.0f} GB/s")
    if not ok:
        raise AssertionError(f"{tag} kernel disagrees ({dtype})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                plain_device_ms=plain_dev_ms)


def phase_kernel_ring(nx, ny, periodic):
    dev = torch.device("cuda")
    if periodic:
        mesh = PeriodicRectangleMesh(nx, ny, L3, L3, direction="x",
                                     device=dev, dtype=torch.float64)
    else:
        mesh = RectangleMesh(nx, ny, LX, LY, device=dev, dtype=torch.float64)
    ring, valid = ring_tables(mesh)
    nc = mesh.nc
    g = torch.Generator(device=dev).manual_seed(1234)
    b64 = torch.randn((4, 9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    x64 = torch.randn((9, nc), generator=g, device=dev, dtype=torch.float64)
    d64 = torch.randn((9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    out = {}
    for dtype in (torch.float64, torch.float32):
        blocks, x, diag = b64.to(dtype), x64.to(dtype), d64.to(dtype)
        es = blocks.element_size()
        out[("ring_mv", dtype)] = check_kernel(
            f"ring_mv nc={nc}", dtype, ringmv.ring_mv(blocks, x, ring, valid),
            ringmv.ring_mv_reference(blocks, x, ring, valid),
            lambda: ringmv.ring_mv(blocks, x, ring, valid),
            lambda: ringmv.ring_mv_reference(blocks, x, ring, valid),
            4 * 81 * nc * es + 2 * 9 * nc * es + nc * 4 * 4 + nc * 4)
        out[("block_diag_mv", dtype)] = check_kernel(
            f"block_diag_mv nc={nc}", dtype, ringmv.block_diag_mv(diag, x),
            ringmv.block_diag_mv_reference(diag, x),
            lambda: ringmv.block_diag_mv(diag, x),
            lambda: ringmv.block_diag_mv_reference(diag, x),
            (81 + 18) * nc * es)
    return out


def phase_kernel_tridiag(batch, n):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=torch.float64) * 2 - 1

    dl, du, rhs = rnd(batch, n), rnd(batch, n), rnd(batch, n)
    dd = 2.0 + dl.abs() + du.abs() + rnd(batch, n).abs()  # dominant
    out = {}
    for dtype in (torch.float64, torch.float32):
        a, b, c, r = (t.to(dtype) for t in (dl, dd, du, rhs))
        out[("tridiag", dtype)] = check_kernel(
            f"tridiag {batch}x{n}", dtype, tridiag.tridiag_solve(a, b, c, r),
            tridiag.tridiag_reference(a, b, c, r),
            lambda: tridiag.tridiag_solve(a, b, c, r),
            lambda: tridiag.tridiag_reference(a, b, c, r),
            5 * batch * n * a.element_size())
    return out


def phase_slice2d(smi):
    mesh, eq, st, sol, fields = workload(torch.device("cuda"), torch.float32)
    n_dofs = mesh.nc * 9
    nsteps = 10

    def step(s):
        return st.advance(0.0, s, fields, fields, {})

    s, t_warm = sync_time(lambda: step(sol))
    log(f"[slice2d] f32 {NX}x{NY}: nc={mesh.nc}, {n_dofs} DOF, dt="
        f"{st.dt:.3f} s; warm-up step {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()

    def run():
        out = s
        for _ in range(nsteps):
            out = step(out)
        return out

    reset_counts()
    s, t = sync_time(run)
    n = counts()
    ms = t / nsteps * 1e3
    mv_per_step = n["ring_mv"] / nsteps
    cycles = (mv_per_step - 1) / (RESTART + 1)
    for k in ("uv", "elev"):
        if tuple(s[k].shape) != tuple(sol[k].shape):
            raise AssertionError(f"{k} shape {tuple(s[k].shape)}")
        if not bool(torch.isfinite(s[k]).all()):
            raise AssertionError(f"non-finite {k} after {nsteps} steps")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"the CN steps missed a kernel: {n}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, t_asm = sync_time(lambda: [eq.assemble_operator_blocks(
        s, fields, {}, st.theta * st.dt, return_residual=True)
        for _ in range(5)])
    asm_ms = t_asm / 5 * 1e3
    log(f"[slice2d] {nsteps} steps: {ms:.2f} ms/step, "
        f"{n_dofs * nsteps / t:.4e} DOF*steps/s; launches {n} "
        f"({mv_per_step:.1f} ring_mv/step = {cycles:.2f} FGMRES cycles of "
        f"{RESTART} + the anchor matvec); peak memory {peak:.2f} GiB")
    log(f"[slice2d] assembly alone {asm_ms:.2f} ms/step; the rest (Krylov, "
        f"block inverse, packing) {ms - asm_ms:.2f} ms/step")
    log(f"[slice2d] max|elev| {float(s['elev'].abs().max()):.4f} m, "
        f"max|uv| {float(s['uv'].abs().max()):.4f} m/s; card: {smi}")
    return n


def compare(tag, a, b, rtol):
    """Every key of GPU state ``a`` against CPU state ``b``."""
    errs = []
    for k in sorted(b):
        ga, cb = a[k].cpu(), b[k]
        err = float((ga - cb).abs().max())
        scale = float(cb.abs().max())
        errs.append(f"{k} {err:.2e}/{scale:.2e}")
        if not (bool(torch.isfinite(ga).all()) and err <= rtol * scale):
            raise AssertionError(f"{tag}: f64 GPU step disagrees with CPU: "
                                 f"{errs}")
    return "; ".join(errs)


def phase_parity2d():
    cpu = workload(torch.device("cpu"), torch.float64)
    gpu = workload(torch.device("cuda"), torch.float64)
    sol_cpu, f_cpu = cpu[3], cpu[4]
    sol_gpu = {k: v.to("cuda") for k, v in sol_cpu.items()}
    reset_counts()
    a, t_gpu = sync_time(
        lambda: gpu[2].advance(0.0, sol_gpu, gpu[4], gpu[4], {}))
    if counts()["ring_mv"] == 0:
        raise AssertionError("the f64 GPU step did not launch the kernel")
    t0 = time.perf_counter()
    b = cpu[2].advance(0.0, sol_cpu, f_cpu, f_cpu, {})
    t_cpu = time.perf_counter() - t0
    errs = compare("parity2d", a, b, PARITY_RTOL)
    log(f"[parity2d] f64 {NX}x{NY} one CN step, GPU kernels {t_gpu:.2f} s "
        f"vs CPU plain {t_cpu:.2f} s: max|diff|/max {errs} <= "
        f"{PARITY_RTOL:g}: ok")


def breakdown3d(s, state, f, reps=3):
    """Synchronized wall time of the step's three parts, entered as
    ``_step`` enters them."""
    parts = {"pre (EOS, head, int_pg)": 0.0,
             "2D CN solve (assembly + FGMRES)": 0.0,
             "post (w, ALE momentum + tracers, limiter, mixing)": 0.0}
    names = list(parts)
    for _ in range(reps):
        (geom0, int_pg, src), t1 = sync_time(lambda: s._pre_fn(state))
        f2 = dict(f)
        f2["momentum_source"] = src
        sw, t2 = sync_time(lambda: s.swe_stepper.advance(
            0.0, {"uv": state["uv"], "elev": state["elev"]}, f2, f2, {}))
        state, t3 = sync_time(lambda: s._post_fn(state, sw, geom0, int_pg,
                                                 f2))
        for k, t in zip(names, (t1, t2, t3)):
            parts[k] += t / reps * 1e3
    return parts, state


def phase_slice3d(smi):
    dev = torch.device("cuda")
    s, state0, f, n_dofs = workload3d(dev, torch.float32)
    nc = s.mesh2d.nc
    state, t_warm = sync_time(lambda: s._step(state0, f, {}))
    log(f"[slice3d] f32 {NX3}x{NY3}x{NZ3}: nc={nc} columns, {n_dofs} DOF, "
        f"dt={s.dt:g} s; warm-up step {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, t = sync_time(lambda: s.advance_n(state, f, {}, STEPS3))
    n = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = t / STEPS3 * 1e3
    per = {k: v / STEPS3 for k, v in n.items()}
    for k, v in out.items():
        if tuple(v.shape) != tuple(state0[k].shape):
            raise AssertionError(f"{k} shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k} after {STEPS3} steps")
    if n["tridiag"] != 2 * STEPS3:
        raise AssertionError(f"tridiag launched {n['tridiag']} times in "
                             f"{STEPS3} steps, not 2 per step")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"the barotropic solve missed a kernel: {n}")
    cycles = n["block_diag_mv"] / STEPS3 / RESTART3
    log(f"[slice3d] {STEPS3} steps: {ms:.2f} ms/step, "
        f"{n_dofs * STEPS3 / t:.4e} DOF*steps/s; launches {n} = per step "
        f"{per} ({cycles:.2f} FGMRES cycles of {RESTART3}); peak memory "
        f"{peak:.2f} GiB; every state field finite")
    log(f"[slice3d] max|elev| {float(out['elev'].abs().max()):.4e} m, "
        f"max|uv| {float(out['uv'].abs().max()):.4e} m/s, max|uv_3d| "
        f"{float(out['uv_3d'].abs().max()):.4e} m/s, temp "
        f"{float(out['temp_3d'].min()):.4f}..{float(out['temp_3d'].max()):.4f}"
        f" C; card: {smi}")
    parts, _ = breakdown3d(s, out, f)
    log("[slice3d] per part, ms/step (synchronized, 3 steps): "
        + "; ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    rows = device_rows(lambda: s._step(out, f, {}))
    log(f"[slice3d] profiler, one step: {sum(r[1] for r in rows)} device "
        f"kernels, device busy {sum(r[0] for r in rows) / 1e3:.2f} ms; top "
        "by device time:")
    for us, cnt, key in rows[:12]:
        log(f"[slice3d]   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")
    return n


def phase_parity3d(nx=NX3, ny=NY3):
    cpu = workload3d(torch.device("cpu"), torch.float64, nx, ny)
    gpu = workload3d(torch.device("cuda"), torch.float64, nx, ny)
    reset_counts()
    a, t_gpu = sync_time(lambda: gpu[0]._step(gpu[1], gpu[2], {}))
    n = counts()
    if min(n.values()) == 0:
        raise AssertionError(f"the f64 GPU 3D step missed a kernel: {n}")
    t0 = time.perf_counter()
    b = cpu[0]._step(cpu[1], cpu[2], {})
    t_cpu = time.perf_counter() - t0
    errs = compare("parity3d", a, b, PARITY_RTOL)
    log(f"[parity3d] f64 {nx}x{ny}x{NZ3} one step, GPU kernels {t_gpu:.2f} s"
        f" vs CPU plain {t_cpu:.2f} s: max|diff|/max {errs} <= "
        f"{PARITY_RTOL:g} x max: ok")


def main():
    name = phase_device()
    smi = card()
    log(f"[device] nvidia-smi: {smi}")
    phase_build()
    kern = {}
    kern.update(phase_kernel_ring(NX3, NY3, periodic=True))
    kern_2d = phase_kernel_ring(NX, NY, periodic=False)
    kern.update(phase_kernel_tridiag(2 * NX3 * NY3 * 2 * 3, NZ3 + 1))
    phase_kernel_tridiag(NX3 * NY3 * 2 * 3, NZ3 + 1)
    phase_kernel_tridiag(4096, 300)
    n2 = phase_slice2d(smi)
    phase_parity2d()
    n3 = phase_slice3d(smi)
    phase_parity3d()
    # kernel times at the 3D main path's shapes; the ring matvec also at
    # the 2D CN bench's ring, as before
    rows = []
    for k in KERNELS:
        k32 = kern[(k, torch.float32)]
        row = {"name": k, "route": "cuda", "source": SOURCES[k][0],
               "replaces": SOURCES[k][1], "launches": n3[k] + n2[k],
               "launches_by_path": {"baroclinic3d": n3[k], "cn2d": n2[k]},
               "max_abs_err": k32["max_abs_err"], "ms": k32["ms"],
               "plain_ms": k32["plain_ms"], "device_ms": k32["device_ms"],
               "plain_device_ms": k32["plain_device_ms"]}
        if k != "tridiag":
            row["ms_cn2d_shape"] = kern_2d[(k, torch.float32)]["ms"]
            row["plain_ms_cn2d_shape"] = kern_2d[(k, torch.float32)][
                "plain_ms"]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
