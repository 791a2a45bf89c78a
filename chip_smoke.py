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
  block-Jacobi;
* the 2D model, ``FlowSolver2d``, entered as a user enters it, on the
  same 320x160 workloads: SSPRK33 (no kernel on its path), the
  semi-implicit CN, the CN under each preconditioner of the CFL policy
  (coarse correction, Schur fieldsplit) and the Newton CN with the
  assembled wave preconditioner (ring matvec and block-Jacobi inside it).

Phases, each printing its lines:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: one nvcc per kernel source, all started together, with seconds;
3. kernels against plain, f64 and f32: ring_mv and block_diag_mv on the
   ragged cases of ``thetis_tpu_torch/kernels/cases.py``, the tridiagonal
   solve on its ragged cases there (column counts around the tile, n = 1
   to 300, one and two right-hand sides a column; two must equal two
   solves of one bit for bit), on operands that start off a 16-byte
   boundary, on broadcast patterns that are copied first and on each side
   of the n at which its general kernel takes over; then every kernel at
   the shapes the port runs it at (nc 4,608 and 102,400; tridiag the
   velocity solve's 13,824 columns of 13 with two right-hand sides sharing
   the coefficients, 13,824 and 27,648 columns of 13, and 4096 columns of
   300), each with one PyTorch call computing the same function as its
   yardstick (cuSPARSE bsrmv, ``torch.bmm``, ``torch.linalg.solve`` on
   dense matrices);
   device time (profiler; at nc 102,400 with the L2 flushed before each
   call, as the solvers call the kernels there, and the kernel's
   back-to-back time beside it), CUDA-event time (median of 50), bytes,
   the bound and the kernel's share of it;
4. 2D slice: 1 warm-up + 10 timed f32 CN steps, launch counts, rates;
5. 2D parity: one f64 step on the GPU (kernels) against the same step on
   the CPU (the port's plain path);
6. 3D slice: 1 warm-up + 20 timed f32 steps (the bench's n), launches per
   step, rates, peak memory, a per-phase breakdown and, from a fresh
   process (``python3 chip_smoke.py profile3d``), the profiler's device
   kernels of one step and of the velocity column solve alone (one
   tridiagonal kernel, no copy of a coefficient);
7. 3D parity: one f64 step on the GPU against the CPU plain path;
8. 2D model, SSPRK33, f32, full size: 1 warm-up + 30 timed steps through
   ``iterate()``, rates, launches, a profiler count per step;
9. 2D model, semi-implicit CN, f32, full size: 1 warm-up + 10 timed
   steps, held against phase 4's final state and launch counts;
10. 2D model, the preconditioner policy, f32, full size: CN at 12 and 50
    hmin/c (coarse correction, Schur fieldsplit) and the Newton CN, 1
    warm-up + 3 timed steps each; setup seconds, Newton iterations,
    FGMRES cycles, launches, ms/step, peak memory, final residuals;
11. 2D model parity, f64, 80x40: one step of each configuration of
    phases 8-10 on the GPU against the CPU plain path.

Then one JSON line describing each kernel (top-level numbers f32 at the
3D step's shape, ``shapes`` every shape and dtype of phase 3), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Any
failed check raises, so the script exits non-zero and prints no result;
without a CUDA device it exits 1 at once.  Run from the repository root:
``python3 chip_smoke.py``.
"""
import json
import math
import os
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from thetis_tpu_torch.config import physical_constants
from thetis_tpu_torch.equations.shallowwater_2d import (
    ShallowWaterEquations, swe_state)
from thetis_tpu_torch.fem.assembly import DGAssembler
from thetis_tpu_torch.fem.functionspace import Function, FunctionSpace
from thetis_tpu_torch.kernels import ringmv, tridiag
from thetis_tpu_torch.equations.momentum_3d import vertical_viscosity_implicit
from thetis_tpu_torch.kernels.cases import (RAGGED_NC, RAGGED_TRIDIAG,
                                            ragged_case, ragged_tridiag_case)
from thetis_tpu_torch.mesh.generation import (PeriodicRectangleMesh,
                                              RectangleMesh)
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d
from thetis_tpu_torch.model.flowsolver3d import FlowSolver
from thetis_tpu_torch.solvers.assembled import get_coloring, ring_tables
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
# flop/s outside the tensor cores (H100 SXM data sheet); no kernel here
# has the reuse that would feed a matrix unit
H100_PEAK = {torch.float32: 67e12, torch.float64: 34e12}
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# one f64 step, GPU kernels vs CPU plain path: same Krylov path, sums in
# other orders; the solve amplifies 1e-16 roundoff by its conditioning
PARITY_RTOL = 1e-9
# phase 9 against phase 4: the two runs hold the 50 m depth as a scalar
# (bench.py) and as the model's CG1 field, which differ in f32 roundoff;
# each step's solve stops at ksp_rtol 1e-5, so over 11 steps the states
# differ at that tolerance, not at roundoff (CPU f32: 2.1e-5 of max on uv)
MODEL_CN_RTOL = 1e-4
KERNELS = ("ring_mv", "tridiag", "block_diag_mv")
STEPS_SSP = 30                          # bench.py:211-212
NX_PARITY, NY_PARITY = 80, 40           # phase 11's CPU-affordable mesh
#: FlowSolver2d configurations: (stepper, semi-implicit, dt in hmin/c,
#: NewtonParameters keywords, the PC the CFL policy should pick).  The
#: coarse / Schur cases take the policy's restart (24) at the bench's
#: ksp_rtol (1e-5; f32 cannot reach the policy's default 1e-7) with 8
#: cycles; the Newton case the policy's restart/cap (8/24) at ksp_rtol
#: 1e-5 and snes_rtol 1e-4: in f32 the Newton residual of this step
#: stalls near 1e-5 of its start (the residual's terms are ~100x the
#: step's change, each rounded at 6e-8), so a lower snes_rtol, the
#: default 1e-8 included, runs every step to snes_max_it = 8 iterations.
MODEL2D = {
    "ssprk33": ("SSPRK33", None, 0.08, None, None),
    "cn": ("CrankNicolson", True, 2.0,
           dict(ksp_rtol=1e-5, ksp_max_it=32, gmres_restart=RESTART),
           "NoneType"),
    "cn_coarse": ("CrankNicolson", True, 12.0,
                  dict(ksp_rtol=1e-5, ksp_max_it=192, gmres_restart=24),
                  "CoarseCorrection"),
    "cn_schur": ("CrankNicolson", True, 50.0,
                 dict(ksp_rtol=1e-5, ksp_max_it=192, gmres_restart=24),
                 "SchurFieldsplitPC"),
    "cn_newton": ("CrankNicolson", False, 2.0,
                  dict(snes_rtol=1e-4, ksp_rtol=1e-5, ksp_max_it=24,
                       gmres_restart=8), "AssembledWavePC"),
}
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
    every device kernel, largest device time first.  Now and then a
    capture comes back without one device record (on the card, of 1 launch
    and of 25, in a fresh process too, and twice running), so an empty one
    is taken again a moment later, five times at most; the callers raise
    if the rows are still empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(5):
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops; their kernels are rows of their own
            us = getattr(e, "self_device_time_total", None)
            rows.append((e.self_cuda_time_total if us is None else us,
                         e.count, e.key))
        if rows:
            break
    return sorted(rows, reverse=True)


def device_ms(fn, reps=20, flush=None):
    """Device time per call: the device kernels' time over ``reps`` calls,
    without the host's gaps between launches (which the CUDA-event time
    of :func:`median_ms` includes).  With ``flush`` (an in-place
    ``bitwise_not_`` of a buffer larger than the L2) run before every
    call, the flush's own kernels are left out of the sum.  The profiler
    can miss a few kernel records of a capture (2 of 20 of one kernel on
    the card), so the sum is divided by the calls it saw of the costliest
    kernel, not by ``reps``."""
    fn()
    torch.cuda.synchronize()  # the warm-up call ends before the capture

    def run():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    rows = [r for r in device_rows(run) if "bitwise_not" not in r[2]]
    if not rows:
        raise RuntimeError(f"the profiler saw no device kernel in {reps} "
                           "calls")
    per_call = max(1, round(rows[0][1] / reps))  # costliest kernel's count
    return sum(r[0] for r in rows) / (rows[0][1] / per_call) / 1e3


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


def model2d(config, device, dtype, nx=NX, ny=NY, mesh=None):
    """The bench's 2D case entered through the model API:
    ``FlowSolver2d(mesh, 50.0)``, ``.options``, ``initialize()`` and
    ``assign_initial_conditions`` (the Gaussian of bench.py:67-70).
    Returns ``(solver, setup seconds)``."""
    stepper, semi, mult, params, _ = MODEL2D[config]
    if mesh is None:
        mesh = RectangleMesh(nx, ny, LX, LY, device=device, dtype=dtype)
    s = FlowSolver2d(mesh, 50.0)
    o = s.options
    o.swe_timestepper_type = stepper
    so = o.swe_timestepper_options
    if semi is None:
        so.use_automatic_timestep = False
    else:
        so.use_semi_implicit_linearization = semi
    if params is not None:
        so.solver_parameters = NewtonParameters(**params)
    o.timestep = mult * float(mesh.cell_hmin_np.min()) / math.sqrt(9.81 * 51.0)
    o.quadratic_drag_coefficient = 2.5e-3
    o.lax_friedrichs_velocity_scaling_factor = 1.0
    o.no_exports = True
    _, t_setup = sync_time(s.initialize)
    # the equation options of bench.py:55-63
    eo = s.eq_sw.options
    want = dict(use_nonlinear_equations=True, use_wetting_and_drying=False,
                use_lax_friedrichs_velocity=True,
                use_grad_div_viscosity_term=False,
                use_grad_depth_viscosity_term=True, sipg_factor=1.0,
                norm_smoother=0.0)
    got = {k: getattr(eo, k) for k in want}
    if got != want:
        raise AssertionError(f"equation options {got} != bench {want}")
    x = s.function_spaces.H_2d.dof_coords()
    s.assign_initial_conditions(elev=torch.exp(
        -(((x[..., 0] - LX / 2) / 15e3) ** 2)
        - ((x[..., 1] - LY / 2) / 15e3) ** 2))
    return s, t_setup


def iterate_steps(s, n):
    """``n`` more steps through ``iterate()``: the end time moves on by
    ``n`` dt and the export interval is set so that they run as one
    loop."""
    o = s.options
    o.simulation_export_time = n * s.dt
    o.simulation_end_time = s.simulation_time + n * s.dt
    s.iterate()


def check_state(tag, s, shapes):
    for k, v in s._get_state().items():
        if tuple(v.shape) != shapes[k]:
            raise AssertionError(f"{tag}: {k} shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: non-finite {k}")


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
    built = build_libraries(KERNELS)
    each = ", ".join(f"{k}.cu {v[0]:.2f} s" for k, v in built.items())
    log(f"[build] {each}; all three in parallel "
        f"{time.perf_counter() - t0:.2f} s -> {BUILD_DIR} (nvcc -gencode "
        "arch=compute_90a,code=sm_90a)")
    for k, (_, out) in built.items():
        for line in out.splitlines():  # registers, shared memory, spills
            if any(w in line for w in ("Compiling", "Used", "spill")):
                log(f"[build] {k}: {line.split(':', 1)[-1].strip()}")


def bound_ms(nbytes, flops, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / H100_BW * 1e3
    t_ops = flops / H100_PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(tag, dtype, got, ref):
    """``got`` against the plain version's ``ref``: finite, and within the
    dtype's tolerance of ``ref``'s largest magnitude (the sums run in
    another order)."""
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_TOL[dtype]
    if not (bool(torch.isfinite(got).all()) and err <= tol * scale):
        raise AssertionError(f"{tag} {dtype}: max|err| {err:.3e} > {tol:g} x "
                             f"max|ref| {scale:.3e}")
    return err, scale


def measure(tag, dtype, kernel, plain, library, nbytes, flops, cold=False,
            lib_reps=(50, 20)):
    """Hold ``kernel()`` and the library call against ``plain()``, then
    time all three: CUDA events (launch included, median of 50, back to
    back) and device time (profiler).  With ``cold`` (an operand outgrows
    the L2, or the port's path evicts it between two calls) the device
    times are taken with the L2 flushed before every call, since that is
    what a caller sees; the kernel's back-to-back time is kept beside them
    as ``warm_device_ms``.  ``library`` is ``(name, fn, to_ref)``,
    ``to_ref`` turning the call's output into the plain layout outside the
    timed call; ``lib_reps`` the calls of it under CUDA events and under
    the profiler (fewer where one call takes a second)."""
    flush = None
    if cold:
        buf = torch.empty(2**25, dtype=torch.int32, device="cuda")  # 128 MB
        flush = buf.bitwise_not_
    ref = plain()
    err, scale = check(tag, dtype, kernel(), ref)
    out = dict(max_abs_err=err, ms=median_ms(kernel),
               plain_ms=median_ms(plain),
               device_ms=device_ms(kernel, flush=flush),
               plain_device_ms=device_ms(plain, flush=flush), bytes=nbytes,
               flops=flops)
    lib_name, lib_fn, to_ref = library
    check(f"{tag} library {lib_name}", dtype, to_ref(lib_fn()), ref)
    out.update(library=lib_name,
               library_ms=median_ms(lib_fn, lib_reps[0],
                                    warm=min(5, lib_reps[0])),
               library_device_ms=device_ms(lib_fn, lib_reps[1], flush))
    lib_txt = (f", library {lib_name} {out['library_device_ms']:.4f}; "
               f"events (launch included) library {out['library_ms']:.4f}")
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops, dtype)
    out["share"] = out["bound_ms"] / out["device_ms"]
    how = "back to back"
    if cold:
        out["warm_device_ms"] = device_ms(kernel)
        out["warm_share"] = out["bound_ms"] / out["warm_device_ms"]
        how = (f"L2 flushed before each call; kernel back to back "
               f"{out['warm_device_ms']:.4f} ms ({out['warm_share']:.0%})")
    log(f"[kernel] {tag} {str(dtype)[6:]}: max|err|={err:.3e} (tol "
        f"{KERNEL_TOL[dtype]:g} x max|ref|={scale:.3e}) ok; device time "
        f"({how}) kernel {out['device_ms']:.4f} ms, plain "
        f"{out['plain_device_ms']:.4f}{lib_txt}; events (launch included, "
        f"back to back) kernel {out['ms']:.4f}, plain {out['plain_ms']:.4f}; "
        f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} Mflop -> bound "
        f"{out['bound_ms']:.4f} ms by {out['bound_by']}, share "
        f"{out['share']:.0%}")
    return out


def ring_bsr(blocks, ring, valid):
    """The ring operator as a ``(9 nc, 9 nc)`` BSR matrix of 9x9 blocks on
    the cell-major vector: one block per valid slot, the blocks of a
    neighbour repeated in a row summed (the yardstick's layout; the port
    never builds it)."""
    nc = blocks.shape[3]
    dev = blocks.device
    keep = valid.reshape(-1)
    rows = torch.arange(nc, device=dev).repeat_interleave(4)[keep]
    cols = ring.reshape(-1).long()[keep]
    vals = blocks.permute(3, 0, 1, 2).reshape(nc * 4, 9, 9)[keep]
    key, inv = torch.unique(rows * nc + cols, sorted=True,
                            return_inverse=True)
    summed = torch.zeros((len(key), 9, 9), dtype=blocks.dtype,
                         device=dev).index_add_(0, inv, vals)
    crow = torch.zeros(nc + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(key // nc, minlength=nc), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "BSR support is in beta"
        return torch.sparse_bsr_tensor(crow, (key % nc).int(), summed,
                                       size=(9 * nc, 9 * nc))


def ring_mv_bytes(nc, n_valid, es):
    """Blocks of the valid slots, x read and y written once, the ring
    table (int32) and the valid mask (bytes)."""
    return n_valid * 81 * es + 2 * 9 * nc * es + nc * 4 * 4 + nc * 4


def phase_kernel_ragged():
    """Both ring kernels against their plain versions on the ragged cases
    the CPU tests hold against the JAX package (kernels/cases.py)."""
    dev = torch.device("cuda")
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    for nc in RAGGED_NC:
        blocks, x, diag, ring, valid = ragged_case(nc, seed=nc)
        ring = torch.as_tensor(ring, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        errs = []
        for dtype in (torch.float64, torch.float32):
            b, xx, d = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in (blocks, x, diag))
            e1, s1 = check(f"ring_mv ragged nc={nc}", dtype,
                           ringmv.ring_mv(b, xx, ring, valid),
                           ringmv.ring_mv_reference(b, xx, ring, valid))
            e2, s2 = check(f"block_diag_mv ragged nc={nc}", dtype,
                           ringmv.block_diag_mv(d, xx),
                           ringmv.block_diag_mv_reference(d, xx))
            errs.append(f"{str(dtype)[6:]} ring_mv {e1:.2e}/{s1:.2e}, "
                        f"block_diag_mv {e2:.2e}/{s2:.2e}")
        log(f"[kernel] ragged nc={nc} ({int((~valid.any(1)).sum())} rows "
            f"with no valid slot): max|err|/max|ref| {'; '.join(errs)}: ok")


def phase_kernel_ring(nx, ny, periodic):
    dev = torch.device("cuda")
    if periodic:
        mesh = PeriodicRectangleMesh(nx, ny, L3, L3, direction="x",
                                     device=dev, dtype=torch.float64)
    else:
        mesh = RectangleMesh(nx, ny, LX, LY, device=dev, dtype=torch.float64)
    ring, valid = ring_tables(mesh)
    nc = mesh.nc
    n_valid = int(valid.sum())
    g = torch.Generator(device=dev).manual_seed(1234)
    b64 = torch.randn((4, 9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    x64 = torch.randn((9, nc), generator=g, device=dev, dtype=torch.float64)
    d64 = torch.randn((9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    # where the f32 blocks outgrow the 50 MB L2, the solvers' other work
    # evicts D too (a ring matvec runs between two block-Jacobi applies)
    cold = 4 * 81 * nc * 4 > 50e6
    out = {}
    for dtype in (torch.float64, torch.float32):
        blocks, x, diag = b64.to(dtype), x64.to(dtype), d64.to(dtype)
        es = blocks.element_size()
        A = ring_bsr(blocks, ring, valid)
        xc = x.T.contiguous().reshape(-1)
        out[("ring_mv", dtype)] = measure(
            f"ring_mv nc={nc}", dtype,
            lambda: ringmv.ring_mv(blocks, x, ring, valid),
            lambda: ringmv.ring_mv_reference(blocks, x, ring, valid),
            ("cuSPARSE bsrmv (torch.mv of a BSR tensor)",
             lambda: torch.mv(A, xc), lambda y: y.reshape(nc, 9).T),
            ring_mv_bytes(nc, n_valid, es), 2 * 81 * n_valid, cold)
        dc = diag.permute(2, 0, 1).contiguous()
        rc = x.T.contiguous()[:, :, None]
        out[("block_diag_mv", dtype)] = measure(
            f"block_diag_mv nc={nc}", dtype,
            lambda: ringmv.block_diag_mv(diag, x),
            lambda: ringmv.block_diag_mv_reference(diag, x),
            ("torch.bmm (nc, 9, 9) x (nc, 9, 1)", lambda: torch.bmm(dc, rc),
             lambda z: z[:, :, 0].T),
            (81 + 18) * nc * es, 2 * 81 * nc, cold)
    return out


def phase_kernel_tridiag_ragged():
    """The tridiagonal kernels against the plain version on the ragged
    cases the CPU tests hold against the JAX package (kernels/cases.py),
    and where the wrapper's decisions change."""
    dev = torch.device("cuda")
    worst = {torch.float64: 0.0, torch.float32: 0.0}

    def held(tag, dtype, ops):
        got = tridiag.tridiag_solve(*ops)
        err, scale = check(tag, dtype, got, tridiag.tridiag_reference(*ops))
        worst[dtype] = max(worst[dtype], err / scale)
        return got

    for bc, n, nrhs in RAGGED_TRIDIAG:
        ops64 = [torch.as_tensor(a, device=dev)
                 for a in ragged_tridiag_case(bc, n, nrhs, seed=bc + n)]
        for dtype in worst:
            ops = [a.to(dtype) for a in ops64]
            tag = f"tridiag ragged {bc}x{n} R={nrhs}"
            got = held(tag, dtype, ops)
            if nrhs > 1:  # each right-hand side alone: the same bits
                alone = torch.stack([tridiag.tridiag_solve(*ops[:3], r)
                                     for r in ops[3]])
                if not torch.equal(alone, got):
                    raise AssertionError(f"{tag} {dtype}: R = {nrhs} differs "
                                         f"from {nrhs} solves of one")
            elif bc > 1:  # contiguous views starting one column in: off
                # the 16-byte boundary for odd n, so no vector copies
                off = [a[1:] for a in ops]
                if not torch.equal(tridiag.tridiag_solve(*off), got[1:]):
                    raise AssertionError(f"{tag} {dtype}: a view one column "
                                         "in gives other bits")
    log(f"[kernel] tridiag ragged: {len(RAGGED_TRIDIAG)} cases (columns x "
        f"rows x right-hand sides) in f64 and f32, R = 2 bit-equal to two "
        f"solves, offset views bit-equal: worst max|err|/max|ref| "
        + ", ".join(f"{str(k)[6:]} {v:.2e} (tol {KERNEL_TOL[k]:g})"
                    for k, v in worst.items()) + ": ok")
    # each side of the n at which no tile fits in shared memory any more
    for dtype in worst:
        es = torch.empty((), dtype=dtype).element_size()
        for nrhs in (1, 2):
            n = 1
            while tridiag.tile_geometry(1, n, es, nrhs) is not None:
                n += 1
            for m in (n - 1, n):
                ops = [torch.as_tensor(a, device=dev).to(dtype)
                       for a in ragged_tridiag_case(70, m, nrhs, seed=m)]
                geom = tridiag.tile_geometry(70, m, es, nrhs)
                held(f"tridiag 70x{m} R={nrhs}", dtype, ops)
                log(f"[kernel] tridiag 70x{m} R={nrhs} {str(dtype)[6:]}: "
                    + ("general kernel" if geom is None else
                       f"tiled, {geom.cols} columns and {geom.smem_bytes} "
                       "shared bytes a block") + ": ok")
    # three and four right-hand sides a column go through the tile's one
    # or two slots in turns
    for nrhs, n in ((3, 13), (4, 14)):
        ops = [torch.as_tensor(a, device=dev)
               for a in ragged_tridiag_case(1000, n, nrhs, seed=nrhs)]
        got = held(f"tridiag 1000x{n} R={nrhs}", torch.float64, ops)
        alone = torch.stack([tridiag.tridiag_solve(*ops[:3], r)
                             for r in ops[3]])
        if not torch.equal(alone, got):
            raise AssertionError(f"tridiag R = {nrhs} differs from {nrhs} "
                                 "solves of one")
    # broadcast patterns the wrapper copies first (tests/test_torch_tridiag)
    rng = np.random.default_rng(7)
    for shapes in ([(4,), (4,), (4,), (2, 4)],
                   [(2, 6, 3), (6, 3), (6, 3), (6, 3)],
                   [(1, 6, 3), (2, 1, 3), (6, 1), (2, 6, 3)]):
        dl, dd, du, rhs = (rng.uniform(-1, 1, size=sh + (13,))
                           for sh in shapes)
        ops = [torch.as_tensor(a, device=dev) for a in (dl, dd + 4.0, du, rhs)]
        full = torch.broadcast_shapes(*(t.shape for t in ops))
        check(f"tridiag broadcast {shapes}", torch.float64,
              tridiag.tridiag_solve(*ops),
              tridiag.tridiag_reference(*(t.expand(full) for t in ops)))
    log("[kernel] tridiag with 3 and 4 right-hand sides a column, and "
        "broadcast patterns that are copied first: ok")


def phase_kernel_tridiag(bc, n, nrhs=1):
    """``bc`` coefficient columns of ``n`` rows; the right-hand side has
    their shape, or ``(nrhs, bc, n)`` with ``nrhs`` > 1 sharing each
    column's coefficients (the velocity solve: the two components)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=torch.float64) * 2 - 1

    dl, du = rnd(bc, n), rnd(bc, n)
    rhs = rnd(bc, n) if nrhs == 1 else rnd(nrhs, bc, n)
    dd = 2.0 + dl.abs() + du.abs() + rnd(bc, n).abs()  # dominant
    out = {}
    for dtype in (torch.float64, torch.float32):
        a, b, c, r = (t.to(dtype) for t in (dl, dd, du, rhs))
        # the yardstick's dense (bc, n, n) matrices are made outside the
        # timed call (2.9 GB in f64 at 4096 x 300)
        dense = torch.diag_embed(b)
        dense.diagonal(-1, 1, 2).copy_(a[:, 1:])
        dense.diagonal(1, 1, 2).copy_(c[:, :-1])
        cols = r.reshape(nrhs, bc, n).permute(1, 2, 0).contiguous()
        lib = ("torch.linalg.solve, dense batched LU (O(n^3), not O(n))",
               lambda: torch.linalg.solve(dense, cols),
               lambda x: x.permute(2, 0, 1).reshape(r.shape))
        # each operand read once, x written once; Thomas does 3 operations
        # a row to eliminate and 5 a row and right-hand side (2 divisions
        # among the 8)
        tag = f"tridiag {bc}x{n}" + (f" x{nrhs} shared" if nrhs > 1 else "")
        out[("tridiag", dtype)] = measure(
            tag, dtype,
            lambda: tridiag.tridiag_solve(a, b, c, r),
            lambda: tridiag.tridiag_reference(a, b, c, r), lib,
            (3 + 2 * nrhs) * bc * n * a.element_size(),
            (3 + 5 * nrhs) * bc * n,
            lib_reps=(50, 20) if n <= 32 else (5, 3))
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
    return n, s


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
    # the profiler's captures are taken in a process of their own
    # (:func:`profile3d`): late in this long one it loses kernel records
    sub = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "profile3d"],
        capture_output=True, text=True, timeout=300)
    for line in sub.stdout.splitlines():
        if line.startswith("[slice3d]"):
            log(line)
    if sub.returncode != 0:
        raise RuntimeError("the 3D step's profiler captures failed:\n"
                           + sub.stderr[-4000:])
    return n


def profile3d():
    """The profiler's view of the 3D slice, from a fresh process
    (``python3 chip_smoke.py profile3d``, kernels built already): the
    device kernels of the step that follows phase 6's 1 + 20 steps, those
    of the velocity column solve alone, and those of its one call of the
    tridiagonal wrapper, which must be one tiled kernel with two
    right-hand sides a column and nothing else (no copy of a broadcast
    coefficient), allocating only its result.  An empty capture fails."""
    phase_device()
    dev = torch.device("cuda")
    s, state0, f, _ = workload3d(dev, torch.float32)
    nc = s.mesh2d.nc
    out = s.advance_n(s._step(state0, f, {}), f, {}, STEPS3)
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up

    def tridiag_rows(rows):
        return [(cnt, key) for _, cnt, key in rows if "tridiag" in key]

    rows = device_rows(lambda: s._step(out, f, {}))
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in a step")
    log(f"[slice3d] profiler, one step: {sum(r[1] for r in rows)} device "
        f"kernels, device busy {sum(r[0] for r in rows) / 1e3:.2f} ms; top "
        "by device time:")
    for us, cnt, key in rows[:12]:
        log(f"[slice3d]   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")
    if sum(cnt for cnt, _ in tridiag_rows(rows)) != 2:
        raise AssertionError("the step should launch two tridiagonal "
                             f"kernels: {tridiag_rows(rows)}")
    # the velocity column solve alone at the step's shapes (no stress, no
    # drag): both components share (nc, 3, nz + 1) coefficients
    Dn = torch.full((nc, 3, NZ3), DEPTH3 / NZ3, dtype=torch.float32,
                    device=dev)
    nu = torch.full_like(out["uv_3d"][..., 0], 1e-3)
    rows = device_rows(lambda: vertical_viscosity_implicit(
        out["uv_3d"], nu, Dn, s.dt))
    log(f"[slice3d] the velocity column solve alone: "
        f"{sum(r[1] for r in rows)} device kernels, "
        f"{sum(r[0] for r in rows):.1f} us:")
    for us, cnt, key in rows:
        log(f"[slice3d]   {us:8.2f} us  x{cnt:<3d} {key[:100]}")
    tiled = "tridiag_tile_kernel<float, 2>"
    solve = tridiag_rows(rows)
    if len(solve) != 1 or solve[0][0] != 1 or tiled not in solve[0][1]:
        raise AssertionError("the velocity solve should launch the tiled "
                             "kernel with two right-hand sides a column, "
                             f"once: {solve}")
    # and its call of the kernel's wrapper, operands made as vdiff_implicit
    # makes them: the kernel reads them as they are, so the call is that
    # one kernel (no copy of a broadcast coefficient) and one allocation,
    # its result (no scratch)
    uv = out["uv_3d"].movedim(-1, 0)
    prof = torch.cat([uv[..., :, 0], uv[..., -1:, 1]], dim=-1)
    a = torch.rand((nc, 3, NZ3 + 1), dtype=torch.float32, device=dev)
    neg_a, b = -a, 1.0 + 2.0 * a
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    launches = tridiag.launches()
    x = tridiag.tridiag_solve(neg_a, b, neg_a, prof)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    launches = tridiag.launches() - launches
    rows = device_rows(lambda: tridiag.tridiag_solve(neg_a, b, neg_a, prof))
    log(f"[slice3d] tridiag_solve of {tuple(a.shape)} coefficients and a "
        f"{tuple(prof.shape)} right-hand side: {launches} launch, {allocs} "
        "device allocation (the result); device kernels: "
        + "; ".join(f"x{cnt} {key[:70]} {us:.2f} us"
                    for us, cnt, key in rows))
    if (launches, allocs) != (1, 1) or tuple(x.shape) != tuple(prof.shape) \
            or len(rows) != 1 or rows[0][1] != 1 or tiled not in rows[0][2]:
        raise AssertionError(
            "the velocity solve's call of tridiag_solve should be one "
            "launch of the tiled kernel with two right-hand sides a "
            "column, no other device kernel, and allocate only its "
            f"result: {launches} launches, {allocs} allocations, {rows}")


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


def phase_model_ssprk33(smi):
    s, t_setup = model2d("ssprk33", torch.device("cuda"), torch.float32)
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    n_dofs = s.mesh2d.nc * 9
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    log(f"[model2d ssprk33] f32 {NX}x{NY}: nc={s.mesh2d.nc}, {n_dofs} DOF, "
        f"dt={s.dt:.4f} s (0.08 hmin/c); setup {t_setup:.2f} s, warm-up "
        f"step {t_warm * 1e3:.1f} ms")
    reset_counts()
    _, t = sync_time(lambda: iterate_steps(s, STEPS_SSP))
    n = counts()
    check_state("model2d ssprk33", s, shapes)
    if s.iteration != STEPS_SSP + 1:
        raise AssertionError(f"iterate ran {s.iteration} steps")
    ms = t / STEPS_SSP * 1e3
    st = s._get_state()
    f = s._gather_swe_fields()
    rows = device_rows(lambda: s._advance(0.0, st, f, {}, {}, {}))
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in a step")
    log(f"[model2d ssprk33] {STEPS_SSP} steps through iterate(): "
        f"{ms:.2f} ms/step, {n_dofs * STEPS_SSP / t:.4e} DOF*steps/s; "
        f"launches {n} (no kernel on the explicit path); profiler, one "
        f"step: {sum(r[1] for r in rows)} device kernels, device busy "
        f"{sum(r[0] for r in rows) / 1e3:.3f} ms; max|elev| "
        f"{float(st['elev'].abs().max()):.4f} m; card: {smi}")
    return n


def phase_model_cn(smi, n_slice, s_slice):
    s, t_setup = model2d("cn", torch.device("cuda"), torch.float32)
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    nsteps = 10
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t = sync_time(lambda: iterate_steps(s, nsteps))
    n = counts()
    check_state("model2d cn", s, shapes)
    ms = t / nsteps * 1e3
    errs = []
    for k in ("elev", "uv"):
        a, b = s._get_state()[k], s_slice[k]
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        errs.append(f"{k} {err:.2e}/{scale:.2e}")
        if err > MODEL_CN_RTOL * scale:
            raise AssertionError(f"model2d cn: FlowSolver2d state differs "
                                 f"from the hand-wired run: {errs}")
    if (n["ring_mv"], n["block_diag_mv"]) != (n_slice["ring_mv"],
                                              n_slice["block_diag_mv"]):
        raise AssertionError(f"model2d cn launches {n} != hand-wired "
                             f"{n_slice}")
    log(f"[model2d cn] f32 {NX}x{NY}, dt={s.dt:.3f} s (2 hmin/c), policy "
        f"PC {type(s.timestepper.coarse).__name__}: setup {t_setup:.2f} s, "
        f"warm-up {t_warm * 1e3:.1f} ms; {nsteps} steps through iterate(): "
        f"{ms:.2f} ms/step, {9 * s.mesh2d.nc * nsteps / t:.4e} "
        f"DOF*steps/s; launches {n} (= phase 4's); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; against "
        f"phase 4's final state max|diff|/max {'; '.join(errs)} <= "
        f"{MODEL_CN_RTOL:g}; "
        f"card: {smi}")
    return n


def phase_model_policy(smi):
    dev = torch.device("cuda")
    mesh = RectangleMesh(NX, NY, LX, LY, device=dev, dtype=torch.float32)
    _, t_col = sync_time(lambda: get_coloring(mesh))
    n_colors = int(get_coloring(mesh)[2].max()) + 1
    log(f"[model2d policy] distance-2 colouring of {mesh.nc} cells (host): "
        f"{t_col:.2f} s, {n_colors} colours (cached on the mesh)")
    total = {k: 0 for k in KERNELS}
    nsteps = 3
    for config in ("cn_coarse", "cn_schur", "cn_newton"):
        torch.cuda.reset_peak_memory_stats()
        s, t_setup = model2d(config, dev, torch.float32, mesh=mesh)
        ts = s.timestepper
        pc = (ts.preconditioner if config == "cn_newton" else ts.coarse)
        if type(pc).__name__ != MODEL2D[config][4]:
            raise AssertionError(f"{config}: the policy picked "
                                 f"{type(pc).__name__}")
        shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
        _, t_warm = sync_time(lambda: iterate_steps(s, 1))
        reset_counts()
        stats = []

        def run():
            for _ in range(nsteps):
                iterate_steps(s, 1)
                stats.append(dict(ts.stats))

        _, t = sync_time(run)
        n = counts()
        for k in KERNELS:
            total[k] += n[k]
        check_state(f"model2d {config}", s, shapes)
        params = ts.params
        if config == "cn_newton":
            worst = max(x["snes_rel_residual"] for x in stats)
            limit = params.snes_rtol
            newton = sum(x["newton_iterations"] for x in stats) / nsteps
        else:
            worst = max(x["ksp_rel_residual"] for x in stats)
            limit = params.ksp_rtol
            newton = 1.0
        # the Schur fieldsplit is a full PC: no block-Jacobi in that solve
        bjac = config != "cn_schur"
        if n["ring_mv"] == 0 or (n["block_diag_mv"] == 0) == bjac:
            raise AssertionError(f"{config} launches {n}")
        if not worst <= limit:
            raise AssertionError(f"{config}: final relative residual "
                                 f"{worst:.3e} > requested {limit:g}")
        cycles = sum(x["ksp_cycles"] for x in stats) / nsteps
        cfl = s._wave_cfl(ts.theta * s.dt)
        log(f"[model2d {config}] f32 {NX}x{NY}, dt={s.dt:.3f} s "
            f"({MODEL2D[config][2]:g} hmin/c, policy CFL {cfl:.2f}), PC "
            f"{type(pc).__name__}: setup {t_setup:.2f} s, warm-up "
            f"{t_warm * 1e3:.1f} ms; {nsteps} steps {t / nsteps * 1e3:.2f} "
            f"ms/step; Newton iterations/step {newton:.2f}, FGMRES cycles/"
            f"step {cycles:.2f}; per step ring_mv {n['ring_mv'] / nsteps:.1f}"
            f", block_diag_mv {n['block_diag_mv'] / nsteps:.1f}; worst "
            f"final relative residual {worst:.3e} <= {limit:g}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: "
            f"{smi}")
    return total


def phase_model_parity():
    """One f64 step of each configuration on the GPU (kernels) against
    the same step on the CPU (plain path)."""
    for config in MODEL2D:
        out = {}
        secs = {}
        for dev in ("cuda", "cpu"):
            s, t_setup = model2d(config, torch.device(dev), torch.float64,
                                 NX_PARITY, NY_PARITY)
            reset_counts()
            t0 = time.perf_counter()
            iterate_steps(s, 1)
            if dev == "cuda":
                torch.cuda.synchronize()
                n = counts()
            secs[dev] = (t_setup, time.perf_counter() - t0)
            out[dev] = s._get_state()
        bjac = config not in ("ssprk33", "cn_schur")
        if (n["ring_mv"] == 0) != (config == "ssprk33") or \
                (n["block_diag_mv"] == 0) == bjac:
            raise AssertionError(f"parity {config}: GPU step launches {n}")
        errs = compare(f"parity model2d {config}", out["cuda"], out["cpu"],
                       PARITY_RTOL)
        log(f"[parity model2d {config}] f64 {NX_PARITY}x{NY_PARITY} one "
            f"step, GPU kernels setup {secs['cuda'][0]:.2f} s + step "
            f"{secs['cuda'][1]:.2f} s vs CPU plain {secs['cpu'][0]:.2f} + "
            f"{secs['cpu'][1]:.2f} s: max|diff|/max {errs} <= "
            f"{PARITY_RTOL:g}: ok")


def main():
    name = phase_device()
    smi = card()
    log(f"[device] nvidia-smi: {smi}")
    phase_build()
    phase_kernel_ragged()
    phase_kernel_tridiag_ragged()
    # each kernel at the shapes the port runs it at, the 3D step's first
    ring = [(f"nc={NX3 * NY3 * 2}", phase_kernel_ring(NX3, NY3, True)),
            (f"nc={NX * NY * 2}", phase_kernel_ring(NX, NY, False))]
    cols = NX3 * NY3 * 2 * 3  # (cell, node) columns of the 3D mesh
    rows = NZ3 + 1
    # the velocity solve as the step makes it first, then the tracer
    # solve, the velocity solve with its coefficients copied out to the
    # right-hand side's shape (no caller; the same bytes as the first
    # design moved) and a long column (no port shape)
    shapes = {"ring_mv": ring, "block_diag_mv": ring, "tridiag": [
        (f"{cols}x{rows} x2 shared", phase_kernel_tridiag(cols, rows, 2)),
        (f"{cols}x{rows}", phase_kernel_tridiag(cols, rows)),
        (f"{2 * cols}x{rows}", phase_kernel_tridiag(2 * cols, rows)),
        ("4096x300", phase_kernel_tridiag(4096, 300))]}
    t0 = time.perf_counter()
    n2, s2 = phase_slice2d(smi)
    phase_parity2d()
    log(f"[phases 4-5] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n3 = phase_slice3d(smi)
    phase_parity3d()
    log(f"[phases 6-7] {time.perf_counter() - t0:.1f} s")
    nm = {k: 0 for k in KERNELS}
    for phase, args in ((phase_model_ssprk33, (smi,)),
                        (phase_model_cn, (smi, n2, s2)),
                        (phase_model_policy, (smi,))):
        t0 = time.perf_counter()
        n = phase(*args)
        for k in KERNELS:
            nm[k] += n[k]
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_model_parity()
    log(f"[phase_model_parity] {time.perf_counter() - t0:.1f} s")
    # the top-level numbers are f32 at the 3D step's shape; "shapes" has
    # every shape and dtype measured in phase 3
    rows = []
    for k in KERNELS:
        main_shape = shapes[k][0][1][(k, torch.float32)]
        row = {"name": k, "route": "cuda", "source": SOURCES[k][0],
               "replaces": SOURCES[k][1],
               "launches": n3[k] + n2[k] + nm[k],
               "launches_by_path": {"baroclinic3d": n3[k], "cn2d": n2[k],
                                    "flowsolver2d": nm[k]},
               "library": main_shape["library"]}
        row.update({f: main_shape[f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "share", "plain_device_ms",
            "library_device_ms")})
        row["shapes"] = [
            {"shape": label, "dtype": str(dt)[6:],
             **{f: v for f, v in res[(k, dt)].items() if f != "library"}}
            for label, res in shapes[k]
            for dt in (torch.float32, torch.float64)]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["profile3d"]:
        profile3d()
    else:
        main()
