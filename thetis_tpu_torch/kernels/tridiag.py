r"""Batched tridiagonal (Thomas) solve: hand-written CUDA kernel + plain
version.

Replaces ``thetis_tpu/kernels/tridiag.py::_thomas_kernel`` (Pallas, TPU),
which ``tridiag_solve`` reaches for every implicit vertical column solve
of the 3D step (vertical viscosity of both velocity components in one
launch, vertical diffusion of each tracer).

System convention (rows ``i = 0..n-1`` along the LAST axis):

    dl[i] x[i-1] + dd[i] x[i] + du[i] x[i+1] = rhs[i]

``dl[0]`` and ``du[n-1]`` are ignored.  The four operands broadcast
against each other over the leading (batch) axes, as in the reference.

The kernel (``csrc/tridiag.cu``) runs one thread per column and takes any
``n``.  The wrapper :func:`tridiag_solve` runs :func:`tridiag_reference`
for CPU tensors and launches the kernel for CUDA tensors; a CUDA tensor
never takes the plain version, and a build or launch failure raises.
"""
import ctypes

import torch

__all__ = ["tridiag_solve", "tridiag_reference", "launches",
           "reset_launches"]

_counts = {"tridiag": 0}
_FN = {torch.float32: "tridiag_f32", torch.float64: "tridiag_f64"}


def launches():
    """Number of CUDA launches of the tridiagonal kernel since the last
    :func:`reset_launches`."""
    return _counts["tridiag"]


def reset_launches():
    _counts["tridiag"] = 0


def tridiag_reference(dl, dd, du, rhs):
    """Plain PyTorch version: the reference's ``_thomas_scan`` recurrence
    (``thetis_tpu/kernels/tridiag.py:36-58``) as a Python loop over the
    last axis; operands already broadcast to one shape."""
    n = dd.shape[-1]
    cps, dps = [], []
    cp = dp = torch.zeros_like(dd[..., 0])
    for i in range(n):
        m = dd[..., i] - dl[..., i] * cp
        cp = du[..., i] / m
        dp = (rhs[..., i] - dl[..., i] * dp) / m
        cps.append(cp)
        dps.append(dp)
    xs = [None] * n
    x = torch.zeros_like(dd[..., 0])
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=-1)


def _check(dl, dd, du, rhs):
    ops = (("dl", dl), ("dd", dd), ("du", du), ("rhs", rhs))
    if dd.dtype not in _FN:
        raise TypeError(f"tridiag_solve: dtype {dd.dtype} not in "
                        "(float32, float64)")
    for name, t in ops:
        if t.dtype != dd.dtype:
            raise TypeError(f"tridiag_solve: {name} dtype {t.dtype} != "
                            f"{dd.dtype}")
        if t.dim() < 1:
            raise ValueError(f"tridiag_solve: {name} must have a last "
                             "(system) axis")
    devs = {t.device for _, t in ops}
    if len(devs) != 1:
        raise ValueError(f"tridiag_solve: tensors on several devices {devs}")
    try:
        shape = torch.broadcast_shapes(*(t.shape for _, t in ops))
    except RuntimeError as e:
        raise ValueError(f"tridiag_solve: operands do not broadcast: {e}")
    if shape[-1] < 1:
        raise ValueError("tridiag_solve: systems need at least one row")
    return shape


def _lib():
    from .build import load_library

    lib = load_library("tridiag")
    for fn in _FN.values():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def tridiag_solve(dl, dd, du, rhs):
    """Solve batched tridiagonal systems along the last axis; returns x of
    the broadcast shape.

    CPU tensors take :func:`tridiag_reference`; CUDA tensors launch the
    hand-written kernel (built at first use) on the current stream, after
    broadcasting the operands and making them contiguous."""
    shape = _check(dl, dd, du, rhs)
    ops = [t.expand(shape) for t in (dl, dd, du, rhs)]
    if dd.device.type == "cpu":
        return tridiag_reference(*ops)
    if dd.device.type != "cuda":
        raise ValueError(f"tridiag_solve: unsupported device {dd.device}")
    ops = [t.contiguous() for t in ops]
    n = shape[-1]
    batch = ops[0].numel() // n
    x = torch.empty(shape, dtype=dd.dtype, device=dd.device)
    if batch == 0:
        return x
    cp = torch.empty_like(x)
    fn = getattr(_lib(), _FN[dd.dtype])
    with torch.cuda.device(dd.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in ops), x.data_ptr(), cp.data_ptr(),
                 batch, n, stream)
    if err != 0:
        raise RuntimeError(f"tridiag kernel launch failed: CUDA error {err}")
    _counts["tridiag"] += 1
    return x
