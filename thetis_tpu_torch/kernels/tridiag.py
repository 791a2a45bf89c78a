r"""Batched tridiagonal (Thomas) solve: hand-written CUDA kernels + plain
version.

Replaces ``thetis_tpu/kernels/tridiag.py::_thomas_kernel`` (Pallas, TPU),
which ``tridiag_solve`` reaches for every implicit vertical column solve
of the 3D step (vertical viscosity of both velocity components in one
launch, vertical diffusion of each tracer).

System convention (rows ``i = 0..n-1`` along the LAST axis):

    dl[i] x[i-1] + dd[i] x[i] + du[i] x[i+1] = rhs[i]

``dl[0]`` and ``du[n-1]`` are ignored.  The four operands broadcast
against each other over the leading (batch) axes, as in the reference.

``csrc/tridiag.cu`` holds two kernels.  The tiled one moves a tile of
consecutive columns through shared memory (coalesced copies, the sweep out
of shared memory, nothing but operands and result in device memory) and
reads coefficients that several right-hand sides share once;
:func:`tile_geometry` sizes its tiles.  Where a tile of the narrowest
width does not fit in a block's shared memory (columns of 908 rows and
more in f64, 1816 in f32) the general kernel runs one thread per column on
device memory.  :func:`shared_form` decides
from shapes and strides whether the operands can be read as they are
(coefficients ``(..., n)``, right-hand side ``(R, ..., n)``); any other
broadcast pattern is materialised first.

The wrapper :func:`tridiag_solve` runs :func:`tridiag_reference` for CPU
tensors and launches a kernel for CUDA tensors; a CUDA tensor never takes
the plain version, and a build or launch failure raises.
"""
import ctypes
import math
from collections import namedtuple

import torch

__all__ = ["tridiag_solve", "tridiag_reference", "shared_form",
           "tile_geometry", "TileGeometry", "launches", "reset_launches"]

_counts = {"tridiag": 0}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: shared memory a block may have on the H100 (227 KB; above 48 KB the
#: launch sets the kernel's dynamic shared-memory attribute)
_SMEM_MAX = 232448
#: tile widths in columns, the preferred one first: 64 gives 216 blocks at
#: the 3D step's 13,824 columns (132 SMs); the narrower ones keep long
#: columns in the tiled kernel (up to n = 1815 in f32 and 907 in f64)
_TILE_COLS = (64, 32, 16, 8)
#: threads of a block: all copy the tile, the first ``cols`` sweep
_THREADS = 128

TileGeometry = namedtuple("TileGeometry",
                          "cols stride group threads smem_bytes grid")


def launches():
    """Number of CUDA launches of the tridiagonal kernel since the last
    :func:`reset_launches`."""
    return _counts["tridiag"]


def reset_launches():
    _counts["tridiag"] = 0


def tridiag_reference(dl, dd, du, rhs):
    """Plain PyTorch version: the reference's ``_thomas_scan`` recurrence
    (``thetis_tpu/kernels/tridiag.py:36-58``) as a Python loop over the
    last axis; the operands broadcast against each other (coefficients
    shared by several right-hand sides included)."""
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
    if dd.dtype not in _SUFFIX:
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


def shared_form(dl, dd, du, rhs, shape):
    """Whether the kernels can read the operands as given: ``dl``, ``dd``
    and ``du`` have one shape, which is the trailing part of the broadcast
    ``shape``, ``rhs`` has the full shape, and all four are contiguous
    (so none was expanded by the caller).  Returns the number R of
    right-hand sides that share each coefficient column (the product of
    the leading axes that only ``rhs`` has; 1 when all shapes agree), or
    None: the operands must then be broadcast and copied."""
    cs = tuple(dd.shape)
    lead = len(shape) - len(cs)
    if not (tuple(dl.shape) == cs == tuple(du.shape)
            and tuple(rhs.shape) == tuple(shape)
            and tuple(shape[lead:]) == cs
            and all(t.is_contiguous() for t in (dl, dd, du, rhs))):
        return None
    return math.prod(shape[:lead])


def tile_geometry(bc, n, itemsize, nrhs):
    """Launch geometry of the tiled kernel for ``bc`` coefficient columns
    of ``n`` rows, elements of ``itemsize`` bytes and ``nrhs`` right-hand
    sides a column: ``cols`` columns a block (one sweeping thread each, of
    :data:`_THREADS` that copy), ``stride`` words between two columns in
    shared memory (odd, so a warp's columns fall in different banks),
    ``group`` right-hand sides held at a time (2 for even ``nrhs``), the
    block's shared bytes (3 coefficient tiles and ``group``
    right-hand-side tiles) and the grid.  None where even the narrowest
    tile outgrows :data:`_SMEM_MAX`: the general kernel's case."""
    stride = n | 1
    group = 2 if nrhs % 2 == 0 else 1
    for cols in _TILE_COLS:
        smem = (3 + group) * cols * stride * itemsize
        if smem <= _SMEM_MAX:
            return TileGeometry(cols, stride, group, _THREADS, smem,
                                -(-bc // cols))
    return None


def _fn(name, nptr, nint):
    from .build import load_library

    f = getattr(load_library("tridiag"), name)
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_longlong]
                      + [ctypes.c_int] * nint + [ctypes.c_void_p])
    return f


def tridiag_solve(dl, dd, du, rhs):
    """Solve batched tridiagonal systems along the last axis; returns x of
    the broadcast shape.

    CPU tensors take :func:`tridiag_reference`; CUDA tensors launch one
    hand-written kernel (built at first use) on the current stream.
    Operands in the form :func:`shared_form` accepts are read as they are;
    others are broadcast and made contiguous first."""
    shape = _check(dl, dd, du, rhs)
    if dd.device.type == "cpu":
        return tridiag_reference(*(t.expand(shape) for t in (dl, dd, du, rhs)))
    if dd.device.type != "cuda":
        raise ValueError(f"tridiag_solve: unsupported device {dd.device}")
    nrhs = shared_form(dl, dd, du, rhs, shape)
    if nrhs is None:
        dl, dd, du, rhs = (t.expand(shape).contiguous()
                           for t in (dl, dd, du, rhs))
        nrhs = 1
    n = shape[-1]
    x = torch.empty(shape, dtype=dd.dtype, device=dd.device)
    if x.numel() == 0:
        return x
    bc = dd.numel() // n
    if max(-(-bc // _TILE_COLS[-1]), n, nrhs) >= 2**31:
        raise ValueError(f"tridiag_solve: {bc} columns of {n} rows with "
                         f"{nrhs} right-hand sides outgrow the launch")
    ptrs = [t.data_ptr() for t in (dl, dd, du, rhs, x)]
    geom = tile_geometry(bc, n, dd.element_size(), nrhs)
    with torch.cuda.device(dd.device):
        stream = torch.cuda.current_stream().cuda_stream
        if geom is not None:
            err = _fn("tridiag_tile_" + _SUFFIX[dd.dtype], 5, 8)(
                *ptrs, bc, n, nrhs, geom.group, geom.cols, geom.stride,
                geom.threads, geom.smem_bytes, geom.grid, stream)
        else:
            cp = torch.empty_like(dd)  # the general kernel's scratch
            err = _fn("tridiag_general_" + _SUFFIX[dd.dtype], 6, 2)(
                *ptrs, cp.data_ptr(), bc, n, nrhs, stream)
    if err != 0:
        raise RuntimeError(f"tridiag kernel launch failed: CUDA error {err}")
    _counts["tridiag"] += 1
    return x
