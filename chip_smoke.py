"""Smoke run of the PyTorch/CUDA port (``thetis_tpu_torch``) on one GPU.

Drives the port's 2D semi-implicit CrankNicolson step (the ``bench.py``
CN workload: 320x160 rectangle, 102,400 cells, 921,600 DOF, f32) through
the hand-written CUDA ring-matvec kernel, after building the kernel from
``thetis_tpu_torch/csrc`` and holding it against its plain PyTorch
version.  Phases, each printing its lines:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: nvcc of the kernel library, with its seconds;
3. kernel against plain, at the bench's ring, f64 and f32, with times;
4. the slice: 1 warm-up + 10 timed f32 CN steps, launch counts, rates;
5. slice parity: one f64 step on the GPU (kernel) against the same step
   on the CPU (the port's plain path).

Then one JSON line describing each kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; without a CUDA device it
exits 1 at once.  Run from the repository root: ``python3 chip_smoke.py``.
"""
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from thetis_tpu_torch.equations.shallowwater_2d import (
    ShallowWaterEquations, swe_state)
from thetis_tpu_torch.fem.assembly import DGAssembler
from thetis_tpu_torch.fem.functionspace import Function, FunctionSpace
from thetis_tpu_torch.kernels import ringmv
from thetis_tpu_torch.mesh.generation import RectangleMesh
from thetis_tpu_torch.solvers.assembled import ring_tables
from thetis_tpu_torch.solvers.newton import NewtonParameters
from thetis_tpu_torch.timeintegration.steppers import get_stepper

NX, NY, LX, LY = 320, 160, 100e3, 50e3  # bench.py:213-214, :51
RESTART = 8
H100_BW = 3.35e12  # bytes/s, H100 SXM data sheet
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# one f64 step, GPU kernel vs CPU plain path: same Krylov path, sums in
# other orders; the solve amplifies 1e-16 roundoff by its conditioning
PARITY_RTOL = 1e-9


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

    t0 = time.perf_counter()
    ringmv._lib()
    log(f"[build] ring_mv.cu -> {BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc -gencode "
        "arch=compute_90a,code=sm_90a)")


def phase_kernel():
    dev = torch.device("cuda")
    mesh = RectangleMesh(NX, NY, LX, LY, device=dev, dtype=torch.float64)
    ring, valid = ring_tables(mesh)
    nc = mesh.nc
    g = torch.Generator(device=dev).manual_seed(1234)
    b64 = torch.randn((4, 9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    x64 = torch.randn((9, nc), generator=g, device=dev, dtype=torch.float64)
    out = {}
    for dtype in (torch.float64, torch.float32):
        blocks, x = b64.to(dtype), x64.to(dtype)
        y = ringmv.ring_mv(blocks, x, ring, valid)
        ref = ringmv.ring_mv_reference(blocks, x, ring, valid)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        tol = KERNEL_TOL[dtype]
        ok = bool(torch.isfinite(y).all()) and err <= tol * scale
        ms = median_ms(lambda: ringmv.ring_mv(blocks, x, ring, valid))
        plain_ms = median_ms(
            lambda: ringmv.ring_mv_reference(blocks, x, ring, valid))
        es = blocks.element_size()
        nbytes = 4 * 81 * nc * es + 2 * 9 * nc * es + nc * 4 * 4 + nc * 4
        log(f"[kernel] {str(dtype)[6:]} nc={nc}: max|err|={err:.3e} "
            f"(tol {tol:g} x max|y|={scale:.3e}) {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bytes/call "
            f"{nbytes / 1e6:.1f} MB -> bound {nbytes / H100_BW * 1e3:.4f} ms "
            f"at 3.35 TB/s, kernel at {nbytes / ms / 1e6:.0f} GB/s")
        if not ok:
            raise AssertionError(f"ring_mv kernel disagrees ({dtype})")
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_slice(smi):
    mesh, eq, st, sol, fields = workload(torch.device("cuda"), torch.float32)
    n_dofs = mesh.nc * 9
    nsteps = 10

    def step(s):
        return st.advance(0.0, s, fields, fields, {})

    s, t_warm = sync_time(lambda: step(sol))
    log(f"[slice] f32 {NX}x{NY}: nc={mesh.nc}, {n_dofs} DOF, dt="
        f"{st.dt:.3f} s; warm-up step {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    ringmv.reset_launches()

    def run():
        out = s
        for _ in range(nsteps):
            out = step(out)
        return out

    s, t = sync_time(run)
    launches = ringmv.launches()
    ms = t / nsteps * 1e3
    mv_per_step = launches / nsteps
    cycles = (mv_per_step - 1) / (RESTART + 1)
    for k in ("uv", "elev"):
        if tuple(s[k].shape) != tuple(sol[k].shape):
            raise AssertionError(f"{k} shape {tuple(s[k].shape)}")
        if not bool(torch.isfinite(s[k]).all()):
            raise AssertionError(f"non-finite {k} after {nsteps} steps")
    if launches == 0:
        raise AssertionError("the CN steps never launched the ring_mv kernel")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, t_asm = sync_time(lambda: [eq.assemble_operator_blocks(
        s, fields, {}, st.theta * st.dt, return_residual=True)
        for _ in range(5)])
    asm_ms = t_asm / 5 * 1e3
    log(f"[slice] {nsteps} steps: {ms:.2f} ms/step, "
        f"{n_dofs * nsteps / t:.4e} DOF*steps/s; ring_mv launches "
        f"{launches} ({mv_per_step:.1f}/step = {cycles:.2f} FGMRES cycles of "
        f"{RESTART} + the anchor matvec); peak memory {peak:.2f} GiB")
    log(f"[slice] assembly alone {asm_ms:.2f} ms/step; the rest (Krylov, "
        f"block inverse, packing) {ms - asm_ms:.2f} ms/step")
    log(f"[slice] max|elev| {float(s['elev'].abs().max()):.4f} m, "
        f"max|uv| {float(s['uv'].abs().max()):.4f} m/s; card: {smi}")
    return dict(launches=launches, ms=ms)


def phase_parity():
    nx, ny = NX, NY
    cpu = workload(torch.device("cpu"), torch.float64, nx, ny)
    gpu = workload(torch.device("cuda"), torch.float64, nx, ny)
    sol_cpu, f_cpu = cpu[3], cpu[4]
    sol_gpu = {k: v.to("cuda") for k, v in sol_cpu.items()}
    ringmv.reset_launches()
    a, t_gpu = sync_time(
        lambda: gpu[2].advance(0.0, sol_gpu, gpu[4], gpu[4], {}))
    if ringmv.launches() == 0:
        raise AssertionError("the f64 GPU step did not launch the kernel")
    t0 = time.perf_counter()
    b = cpu[2].advance(0.0, sol_cpu, f_cpu, f_cpu, {})
    t_cpu = time.perf_counter() - t0
    errs = []
    for k in ("uv", "elev"):
        ga, cb = a[k].cpu(), b[k]
        err = float((ga - cb).abs().max())
        scale = float(cb.abs().max())
        errs.append(f"{k} max|diff| {err:.3e} (max {scale:.3e})")
        if not (bool(torch.isfinite(ga).all()) and err <= PARITY_RTOL * scale):
            raise AssertionError(f"f64 GPU step disagrees with CPU: {errs}")
    log(f"[parity] f64 {nx}x{ny} one CN step, GPU kernel {t_gpu:.2f} s vs "
        f"CPU plain {t_cpu:.2f} s: {'; '.join(errs)} <= {PARITY_RTOL:g} "
        "x max: ok")


def main():
    name = phase_device()
    smi = card()
    log(f"[device] nvidia-smi: {smi}")
    phase_build()
    kern = phase_kernel()
    sl = phase_slice(smi)
    phase_parity()
    k32 = kern[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "ring_mv", "route": "cuda",
        "source": "thetis_tpu_torch/csrc/ring_mv.cu",
        "replaces": "thetis_tpu/kernels/ringmv.py:45",
        "launches": sl["launches"], "max_abs_err": k32["max_abs_err"],
        "ms": k32["ms"], "plain_ms": k32["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
