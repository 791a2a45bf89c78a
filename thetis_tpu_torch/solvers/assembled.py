r"""Assembled 1-ring Krylov solve (port of the analytic-path parts of
``thetis_tpu/solvers/assembled.py``).

The semi-implicit SWE stage systems are affine in the solution with
exact 1-ring sparsity for P1DG: ``equations/swe_blocks.py`` assembles the
per-step operator as component-major blocks ``(4, 9, 9, nc)`` and the
whole FGMRES loop runs on ring matvecs and block-Jacobi applications (the
two CUDA kernels of ``kernels/ringmv.py``), the analogue of
PETSc's assembled-Jacobian KSP (the reference's 2D default,
``options.py:44-48``).

Not ported: the shift stencil (the CUDA kernel gathers through the ring
table directly, so it needs no per-mesh offset decomposition), colour
probing, the coarse/Schur preconditioners and the custom VJPs.
"""
import numpy as np
import torch

from ..kernels.ringmv import block_diag_mv, ring_mv

__all__ = ["cell_ring", "ring_tables", "batched_inv_small_T", "PackedState",
           "ring_apply", "ring_apply_T", "ring_gmres"]


def cell_ring(mesh):
    """Closed 1-ring table of the dual graph (host numpy).

    Returns ``(ring, valid)``: ``ring`` (nc, 4) int32
    ``[self, n0, n1, n2]`` (neighbour slots point back at ``self`` across
    boundary facets) and ``valid`` (nc, 4) bool mask (False where the
    neighbour slot is a boundary mirror)."""
    cf = np.asarray(mesh.cell_facets_np)
    fc = np.asarray(mesh.facet_cells_np)
    nc = cf.shape[0]
    cells = np.arange(nc, dtype=cf.dtype)
    both = fc[cf]  # (nc, 3, 2)
    nbr = np.where(both[:, :, 0] == cells[:, None],
                   both[:, :, 1], both[:, :, 0])
    ring = np.concatenate([cells[:, None], nbr], axis=1).astype(np.int32)
    valid = np.ones((nc, 4), dtype=bool)
    valid[:, 1:] = nbr != cells[:, None]
    return ring, valid


def ring_tables(mesh):
    """:func:`cell_ring` as device tensors for the ring matvec: ``ring``
    int32 and ``valid`` bool on the mesh's device (converted once, at
    setup)."""
    ring, valid = cell_ring(mesh)
    return (torch.as_tensor(ring, device=mesh.device),
            torch.as_tensor(valid, device=mesh.device))


def batched_inv_small_T(AT):
    """Component-major batched small-matrix inverse ``(d, d, n) -> (d, d,
    n)``.  Uses ``torch.linalg.inv`` (LU with pivoting) on the (n, d, d)
    view; the reference's pivotless Gauss-Jordan agrees to roundoff on
    these diagonally dominant blocks."""
    return torch.linalg.inv(AT.permute(2, 0, 1)).permute(1, 2, 0).contiguous()


def ring_apply(blocks, ring, x):
    """Cell-major blocks ``(nc, 4, do, di)`` applied to ``x`` (nc, di) ->
    (nc, do) by a plain gather (boundary-mirror slots carry zero
    blocks)."""
    return torch.einsum("csoj,csj->co", blocks, x[ring.long()])


def ring_apply_T(blocks_T, x, ring, valid):
    """Component-major ring matvec on a cell-major vector: ``x`` (nc, 9)
    -> (nc, 9) through the ring matvec kernel."""
    return ring_mv(blocks_T, x.T.contiguous(), ring, valid).T


def _ring_solve_impl(blocks_T, ring, valid, b, diag_inv_T, rtol, restart,
                     max_cycles):
    """FGMRES core on a component-major ring operator: ``b`` (nc, d) ->
    ``(x, rnorm, bnorm)`` with x (nc, d).  The Krylov vectors stay
    component-major ``(d, nc)`` flattened."""
    from .newton import _fgmres_flat

    _, d, _, nc = blocks_T.shape

    def mv(v):
        return ring_mv(blocks_T, v.reshape(d, nc), ring, valid).reshape(-1)

    def M(v):  # block-Jacobi: inverted diagonal (slot-0) blocks
        return block_diag_mv(diag_inv_T, v.reshape(d, nc)).reshape(-1)

    x, rnorm, bnorm = _fgmres_flat(mv, b.T.reshape(-1), M, rtol, restart,
                                   max_cycles)
    return x.reshape(d, nc).T, rnorm, bnorm


def ring_gmres(blocks_T, ring, valid, b, x0, r0, rtol=1e-5, restart=24,
               max_cycles=4):
    """Solve ``A x = b`` for a component-major assembled ring operator
    with restarted FGMRES, right-preconditioned by block-Jacobi (inverted
    diagonal blocks), warm-started from ``x0``.

    The residual system ``A dx = r0`` is solved, with ``r0 = b - A x0``
    supplied by the caller (it is known in closed form there), the
    convergence target still anchored to ``||b||``, and ``x = x0 + dx``.
    Like the reference, a solve whose residual grew past ``1e4 ||b||``
    returns NaN (PETSc's divergence tolerance)."""
    tiny = torch.finfo(b.dtype).tiny
    diag_inv_T = batched_inv_small_T(blocks_T[0])
    bnorm = float(torch.linalg.vector_norm(b))
    r0norm = float(torch.linalg.vector_norm(r0))
    dx, rnorm, _ = _ring_solve_impl(
        blocks_T, ring, valid, r0, diag_inv_T,
        float(rtol) * bnorm / max(r0norm, tiny), restart, max_cycles)
    x = x0 + dx
    if rnorm > 1e4 * max(bnorm, tiny):
        x = torch.full_like(x, float("nan"))
    return x


class PackedState:
    """Pack/unpack a dict of (nc, nd[, k]) cell-dof tensors into a single
    (nc, d) matrix, in sorted key order (the reference's pytree order:
    ``elev`` before ``uv``)."""

    def __init__(self, template):
        self.keys = sorted(template)
        leaves = [template[k] for k in self.keys]
        self.nc = leaves[0].shape[0]
        self.shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self.d = sum(self.sizes)

    def pack(self, tree):
        return torch.cat([tree[k].reshape(self.nc, -1) for k in self.keys],
                         dim=-1)

    def unpack(self, x):
        out = {}
        off = 0
        for k, s, size in zip(self.keys, self.shapes, self.sizes):
            out[k] = x[:, off:off + size].reshape((self.nc,) + s)
            off += size
        return out
