r"""Assembled 1-ring block matvec and block-Jacobi apply: hand-written CUDA
kernels + plain versions.

Replaces ``thetis_tpu/kernels/ringmv.py::_mv_kernel`` (Pallas, TPU), which
``ShiftStencil.apply_T`` reaches through ``ring_mv_pallas`` for every
FGMRES matvec of the assembled semi-implicit CN solve:

    y[i, c] = sum_{s: valid[c, s]} sum_k B[s, i, k, c] * x[k, ring[c, s]]

with blocks ``(4, 9, 9, nc)``, ``x``/``y`` ``(9, nc)`` (component-major,
cell index last), ``ring`` ``(nc, 4)`` int32 and ``valid`` ``(nc, 4)``
bool.  This equals ``ring_apply(blocks, ring, x)`` for the whole
operator: the ring gather already covers the nonconforming rows that the
TPU's shift stencil adds as separate corrections.

The kernel (``csrc/ring_mv.cu``) runs one thread per cell; its bound is
the device-memory bytes of the blocks (see the source note).  The
wrapper :func:`ring_mv` runs :func:`ring_mv_reference` for CPU tensors
and launches the kernel for CUDA tensors; a CUDA tensor never takes the
plain version, and a build or launch failure raises.

:func:`block_diag_mv` replaces ``thetis_tpu/kernels/ringmv.py::
_bjac_kernel``: the per-cell block-diagonal apply ``z[:, c] = D[:, :, c]
r[:, c]`` that the assembled ring solve uses as its block-Jacobi
preconditioner on every FGMRES iteration (``csrc/block_diag_mv.cu``, the
same dispatch rules).
"""
import ctypes

import torch

__all__ = ["ring_mv", "ring_mv_reference", "block_diag_mv",
           "block_diag_mv_reference", "launches", "reset_launches", "NS", "D"]

NS = 4   # ring slots: self + 3 facet neighbours
D = 9    # packed P1DG dofs per cell: eta(3) + uv(6)

_counts = {"ring_mv": 0, "block_diag_mv": 0}
_FN = {torch.float32: "ring_mv_f32", torch.float64: "ring_mv_f64"}
_FN_BD = {torch.float32: "block_diag_mv_f32",
          torch.float64: "block_diag_mv_f64"}


def launches(name="ring_mv"):
    """Number of CUDA launches of kernel ``name`` (``"ring_mv"`` or
    ``"block_diag_mv"``) since the last :func:`reset_launches`."""
    return _counts[name]


def reset_launches():
    for k in _counts:
        _counts[k] = 0


def ring_mv_reference(blocks_T, x_T, ring, valid):
    """Plain PyTorch version: gather ``x_T[:, ring]``, mask the invalid
    (boundary-mirror) slots, contract with the blocks."""
    xg = x_T[:, ring.T.long()]                      # (D, NS, nc)
    xg = torch.where(valid.T[None], xg, torch.zeros_like(xg))
    return torch.einsum("sikc,ksc->ic", blocks_T, xg)


def _check(blocks_T, x_T, ring, valid):
    if blocks_T.dtype not in _FN:
        raise TypeError(f"ring_mv: blocks dtype {blocks_T.dtype} not in "
                        "(float32, float64)")
    if x_T.dtype != blocks_T.dtype:
        raise TypeError(f"ring_mv: x dtype {x_T.dtype} != blocks dtype "
                        f"{blocks_T.dtype}")
    if blocks_T.dim() != 4 or tuple(blocks_T.shape[:3]) != (NS, D, D):
        raise ValueError(f"ring_mv: blocks must be ({NS}, {D}, {D}, nc), "
                         f"got {tuple(blocks_T.shape)}")
    nc = blocks_T.shape[3]
    if tuple(x_T.shape) != (D, nc):
        raise ValueError(f"ring_mv: x must be ({D}, {nc}), got "
                         f"{tuple(x_T.shape)}")
    if ring.dtype != torch.int32 or tuple(ring.shape) != (nc, NS):
        raise ValueError(f"ring_mv: ring must be int32 ({nc}, {NS}), got "
                         f"{ring.dtype} {tuple(ring.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (nc, NS):
        raise ValueError(f"ring_mv: valid must be bool ({nc}, {NS}), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    devs = {t.device for t in (blocks_T, x_T, ring, valid)}
    if len(devs) != 1:
        raise ValueError(f"ring_mv: tensors on several devices {devs}")
    for name, t in (("blocks", blocks_T), ("x", x_T), ("ring", ring),
                    ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"ring_mv: {name} must be contiguous")
    return nc


def _lib():
    from .build import load_library

    lib = load_library("ring_mv")
    for fn in _FN.values():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                  ctypes.c_void_p]
    return lib


def ring_mv(blocks_T, x_T, ring, valid):
    """``y_T (9, nc)`` of the assembled ring operator applied to ``x_T``.

    CPU tensors take :func:`ring_mv_reference`; CUDA tensors launch the
    hand-written kernel (built at first use) on the current stream."""
    nc = _check(blocks_T, x_T, ring, valid)
    if blocks_T.device.type == "cpu":
        return ring_mv_reference(blocks_T, x_T, ring, valid)
    if blocks_T.device.type != "cuda":
        raise ValueError(f"ring_mv: unsupported device {blocks_T.device}")
    y = torch.empty_like(x_T)
    if nc == 0:
        return y
    fn = getattr(_lib(), _FN[blocks_T.dtype])
    with torch.cuda.device(blocks_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blocks_T.data_ptr(), x_T.data_ptr(), ring.data_ptr(),
                 valid.data_ptr(), y.data_ptr(), nc, stream)
    if err != 0:
        raise RuntimeError(f"ring_mv kernel launch failed: CUDA error {err}")
    _counts["ring_mv"] += 1
    return y


def block_diag_mv_reference(diag_T, r_T):
    """Plain PyTorch version: the einsum ``"ijc,jc->ic"`` of the
    reference's block-Jacobi apply."""
    return torch.einsum("ijc,jc->ic", diag_T, r_T)


def _check_bd(diag_T, r_T):
    if diag_T.dtype not in _FN_BD:
        raise TypeError(f"block_diag_mv: diag dtype {diag_T.dtype} not in "
                        "(float32, float64)")
    if r_T.dtype != diag_T.dtype:
        raise TypeError(f"block_diag_mv: r dtype {r_T.dtype} != diag dtype "
                        f"{diag_T.dtype}")
    if diag_T.dim() != 3 or tuple(diag_T.shape[:2]) != (D, D):
        raise ValueError(f"block_diag_mv: diag must be ({D}, {D}, nc), got "
                         f"{tuple(diag_T.shape)}")
    nc = diag_T.shape[2]
    if tuple(r_T.shape) != (D, nc):
        raise ValueError(f"block_diag_mv: r must be ({D}, {nc}), got "
                         f"{tuple(r_T.shape)}")
    if diag_T.device != r_T.device:
        raise ValueError(f"block_diag_mv: tensors on several devices "
                         f"{diag_T.device}, {r_T.device}")
    for name, t in (("diag", diag_T), ("r", r_T)):
        if not t.is_contiguous():
            raise ValueError(f"block_diag_mv: {name} must be contiguous")
    return nc


def _lib_bd():
    from .build import load_library

    lib = load_library("block_diag_mv")
    for fn in _FN_BD.values():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                  ctypes.c_void_p]
    return lib


def block_diag_mv(diag_T, r_T):
    """``z_T (9, nc)`` of the per-cell blocks ``diag_T (9, 9, nc)``
    applied to ``r_T (9, nc)`` (component-major).

    CPU tensors take :func:`block_diag_mv_reference`; CUDA tensors launch
    the hand-written kernel (built at first use) on the current stream."""
    nc = _check_bd(diag_T, r_T)
    if diag_T.device.type == "cpu":
        return block_diag_mv_reference(diag_T, r_T)
    if diag_T.device.type != "cuda":
        raise ValueError(f"block_diag_mv: unsupported device {diag_T.device}")
    z = torch.empty_like(r_T)
    if nc == 0:
        return z
    fn = getattr(_lib_bd(), _FN_BD[diag_T.dtype])
    with torch.cuda.device(diag_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(diag_T.data_ptr(), r_T.data_ptr(), z.data_ptr(), nc, stream)
    if err != 0:
        raise RuntimeError(
            f"block_diag_mv kernel launch failed: CUDA error {err}")
    _counts["block_diag_mv"] += 1
    return z
