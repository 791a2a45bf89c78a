r"""Assembled 1-ring block operators, their Krylov solve and the
assembled preconditioners (port of ``thetis_tpu/solvers/assembled.py``).

The semi-implicit SWE stage systems are affine in the solution with
exact 1-ring sparsity for P1DG: ``equations/swe_blocks.py`` assembles the
per-step operator analytically as component-major blocks
``(4, 9, 9, nc)``, and the whole FGMRES loop runs on ring matvecs and
block-Jacobi applications (the two CUDA kernels of ``kernels/ringmv.py``),
the analogue of PETSc's assembled-Jacobian KSP (the reference's 2D
default, ``options.py:44-48``).

Ported here as well:

* graph-colour probing (:func:`distance2_coloring`,
  :func:`assemble_ring_blocks`, :func:`assemble_affine_operator`): the
  exact 1-ring blocks of any affine, facet-coupled operator from
  ``n_colors x 9`` tangent probes (``torch.func.jvp`` under
  ``torch.func.vmap``), at set-up or when the analytic assembly does not
  apply;
* the two-level preconditioner (:func:`aggregate_cells`,
  :class:`CoarseCorrection`, the V-cycle in :func:`ring_gmres`) and the
  full-PC hook that :class:`~.fieldsplit.SchurFieldsplitPC` plugs into;
* :class:`AssembledWavePC`, the setup-time wave-Jacobian preconditioner
  of the matrix-free Newton CrankNicolson.

Every 9x9 ring matvec and block-Jacobi apply goes through
:func:`~thetis_tpu_torch.kernels.ringmv.ring_mv` /
:func:`~thetis_tpu_torch.kernels.ringmv.block_diag_mv`, so on a CUDA
mesh they are the hand-written kernels.

The solve is differentiable by the implicit function theorem, as the
reference's ``_ring_solve`` ``custom_vjp``: :class:`_RingSolve` runs
FGMRES under ``no_grad`` and its backward solves ``A^T lam = xbar`` with
the same FGMRES, kernels and preconditioner on the transposed blocks
(:func:`~thetis_tpu_torch.kernels.ringmv.ring_transpose_T`,
:meth:`CoarseCorrection.transpose`,
``SchurFieldsplitPC.transpose``).  The ring matvecs outside the solve
(:func:`ring_apply_T`) go through the differentiable
:class:`~thetis_tpu_torch.kernels.ringmv.RingMV`.

Not ported: the shift stencil (the CUDA kernel gathers through the ring
table directly, so it needs no per-mesh offset decomposition).
"""
import copy

import numpy as np
import torch

from ..kernels.ringmv import (RingMV, block_diag_mv, ring_mv,
                              ring_reverse, ring_transpose_T)

__all__ = ["AssembledWavePC", "cell_ring", "ring_tables",
           "distance2_coloring", "assemble_ring_blocks", "get_coloring",
           "assemble_affine_operator", "batched_inv_small",
           "batched_inv_small_T", "cell_to_T",
           "PackedState", "ring_apply", "ring_apply_T", "ring_gmres",
           "aggregate_cells", "CoarseCorrection"]

_WAVE = frozenset(["ExternalPressureGradientTerm", "HUDivTerm"])


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
    int32 and ``valid`` bool on the mesh's device (converted once per
    mesh and cached on it)."""
    cached = getattr(mesh, "_ring_tables", None)
    if cached is None:
        ring, valid = cell_ring(mesh)
        cached = (torch.as_tensor(ring, device=mesh.device),
                  torch.as_tensor(valid, device=mesh.device))
        mesh._ring_tables = cached
    return cached


def distance2_coloring(ring, valid):
    """Greedy proper colouring of the *square* of the dual graph: any two
    cells at distance <= 2 receive different colours, so every closed
    1-ring holds pairwise-distinct colours.  Max dual degree 3 =>
    typically 5-6, at most ~10 colours.  A host loop over the cells in
    index order (the reference's greedy order, so the colours are the
    reference's); paid once per mesh (:func:`get_coloring`)."""
    nc = ring.shape[0]
    ring2 = ring[ring].reshape(nc, -1).tolist()  # 2-ring incl. duplicates
    colors = [-1] * nc
    for c in range(nc):
        used = {colors[k] for k in ring2[c]}
        col = 0
        while col in used:
            col += 1
        colors[c] = col
    return np.asarray(colors, dtype=np.int64)


def get_coloring(mesh):
    """Cached (ring, valid, colors) host tables for a mesh."""
    cached = getattr(mesh, "_ring_coloring", None)
    if cached is None:
        ring, valid = cell_ring(mesh)
        cached = (ring, valid, distance2_coloring(ring, valid))
        mesh._ring_coloring = cached
    return cached


def assemble_ring_blocks(linop, in_dim, out_dim, ring, valid, colors,
                         n_colors, nc, dtype, device, chunk_size=None):
    """Assemble the cell-major 1-ring blocks of a linear operator with
    nearest-neighbour coupling.

    :arg linop: UNBATCHED linear map ``(nc, in_dim) -> (nc, out_dim)``
    :returns: blocks ``(nc, 4, out_dim, in_dim)``, zeroed on invalid
        (boundary-mirror) slots

    For each (colour k, packed dof i) the probe ``t[c'] = e_i if
    color[c'] == k else 0`` isolates exactly one ring member per cell, so
    ``(W t)[c]`` is column i of the block ``W[c, n]`` for the member n of
    colour k.  The ``n_colors * in_dim`` probes ride a leading vmapped
    axis (``chunk_size`` bounds how many are evaluated at once)."""
    P = n_colors * in_dim
    onehot = (colors[:, None] == np.arange(n_colors)[None, :]).astype(
        np.float64)  # (nc, K)
    # probes[(k, i), c, j] = onehot[c, k] * eye[j, i]
    probes = (onehot.T[:, None, :, None]
              * np.eye(in_dim)[None, :, None, :]).reshape(P, nc, in_dim)
    probes = torch.as_tensor(probes, dtype=dtype, device=device)
    Y = torch.func.vmap(linop, chunk_size=chunk_size)(probes)  # (P, nc, o)
    Y = Y.reshape(n_colors, in_dim, nc, out_dim).permute(2, 0, 3, 1)
    cidx = torch.as_tensor(colors[ring], device=device)  # (nc, 4)
    # blocks[c, s, o, j] = Y[c, color[ring[c, s]], o, j]
    blocks = Y[torch.arange(nc, device=device)[:, None], cidx]
    mask = torch.as_tensor(valid, dtype=dtype, device=device)
    return blocks * mask[:, :, None, None]


def assemble_affine_operator(F, x0, mesh, chunk_size=None):
    """Assemble an affine 1-ring-local operator ``F(x) = A x - b`` on
    packed cell dofs.

    :arg F: function (nc, d) -> (nc, d), affine in its argument with
        nearest-neighbour (facet) coupling only
    :arg x0: (nc, d) point to linearize about (exact for affine F)
    :returns: ``(blocks, f0)`` — cell-major ``blocks`` (nc, 4, d, d) such
        that ``A x = ring_apply(blocks, ring, x)``, and ``f0 = F(0) =
        -b``."""
    ring, valid, colors = get_coloring(mesh)
    nc, d = x0.shape
    n_colors = int(colors.max()) + 1

    def A(v):
        return torch.func.jvp(F, (x0,), (v,))[1]

    f0 = F(x0) - A(x0)  # affine: F(0) = F(x0) - A x0
    blocks = assemble_ring_blocks(A, d, d, ring, valid, colors, n_colors,
                                  nc, x0.dtype, x0.device,
                                  chunk_size=chunk_size)
    return blocks, f0


def batched_inv_small_T(AT):
    """Component-major batched small-matrix inverse ``(d, d, n) -> (d, d,
    n)``.  Uses ``torch.linalg.inv`` (LU with pivoting) on the (n, d, d)
    view; the reference's pivotless Gauss-Jordan agrees to roundoff on
    these diagonally dominant blocks."""
    return torch.linalg.inv(AT.permute(2, 0, 1)).permute(1, 2, 0).contiguous()


def batched_inv_small(A):
    """Batch-leading small-matrix inverse ``(n, d, d) -> (n, d, d)``, the
    reference's layout of :func:`batched_inv_small_T`."""
    return torch.linalg.inv(A)


def cell_to_T(blocks):
    """Cell-major ring blocks ``(nc, 4, do, di)`` -> the component-major
    ``(4, do, di, nc)`` layout the ring matvec kernel reads."""
    return blocks.permute(1, 2, 3, 0).contiguous()


def ring_apply(blocks, ring, x):
    """Cell-major blocks ``(nc, 4, do, di)`` applied to ``x`` (nc, di) ->
    (nc, do) by a plain gather (boundary-mirror slots carry zero
    blocks).  For the fieldsplit's non-9x9 sub-blocks and for tests; the
    9x9 operators go through :func:`ring_apply_T`."""
    return torch.einsum("csoj,csj->co", blocks, x[ring.long()])


def ring_apply_T(blocks_T, x, ring, valid):
    """Component-major ring matvec on a cell-major vector: ``x`` (nc, 9)
    -> (nc, 9) through the ring matvec kernel (differentiable,
    :class:`~thetis_tpu_torch.kernels.ringmv.RingMV`)."""
    return RingMV.apply(blocks_T, x.T.contiguous(), ring, valid).T


def aggregate_cells(mesh, target_size=96):
    """Geometric aggregation of cells into contiguous patches (the
    coarse space of the two-level preconditioner): bin cell centroids
    into a rectangular grid sized for ~``target_size`` cells per
    aggregate.  Returns (agg_ids (nc,), n_agg).  Host numpy, as the
    reference."""
    mids = np.asarray(mesh.coords_np)[np.asarray(mesh.cells_np)].mean(axis=1)
    nc = mids.shape[0]
    n_agg_target = max(1, nc // int(target_size))
    lo, hi = mids.min(0), mids.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    aspect = ext[0] / ext[1]
    nbx = max(1, int(round(np.sqrt(n_agg_target * aspect))))
    nby = max(1, int(round(n_agg_target / nbx)))
    ix = np.minimum((mids[:, 0] - lo[0]) / ext[0] * nbx, nbx - 1e-9).astype(int)
    iy = np.minimum((mids[:, 1] - lo[1]) / ext[1] * nby, nby - 1e-9).astype(int)
    raw = ix * nby + iy
    # compress empty bins
    uniq, agg = np.unique(raw, return_inverse=True)
    return agg.astype(np.int32), len(uniq)


def aggregate_segments(agg, n_agg, device):
    """(order, lengths) on ``device``: the cells sorted by aggregate and
    each aggregate's cell count, the segments of :func:`restrict`."""
    agg = np.asarray(agg, dtype=np.int64)
    order = np.argsort(agg, kind="stable")
    lengths = np.bincount(agg, minlength=n_agg)
    return (torch.as_tensor(order, device=device),
            torch.as_tensor(lengths, device=device))


def restrict(r, segments):
    """(nc, k) -> (n_agg, k): the sum of ``r``'s rows over each aggregate
    of :func:`aggregate_segments`, a sorted segment sum that adds in one
    fixed order on every device (a CUDA ``index_add_`` adds in the order
    its atomics land, so two evaluations of one functional on the card
    differed in the last bit; the inversion examples'
    ``consistency_test`` asks for equal ones)."""
    order, lengths = segments
    return torch.segment_reduce(r[order], "sum", lengths=lengths,
                                unsafe=True)


class CoarseCorrection:
    """Galerkin coarse correction for an assembled 1-ring operator.

    The coarse space is piecewise-constant per aggregate: P injects
    coarse dofs to cells, ``A_c = P^T A P`` is formed from the 1-ring
    blocks on the host (float64) ONCE at setup and inverted densely; each
    application is a segment-sum restriction (:func:`restrict`), one
    dense matvec and a gather prolongation.

    :arg blocks: cell-major blocks (nc, 4, d, d) on the solve's device
    :arg ring: (nc, 4) closed 1-ring table (host numpy)
    :arg fields: ``None`` for the reference's coarse space, one coarse
        dof per (aggregate, packed dof component); or a (d,) int map from
        packed component to field, for one coarse dof per (aggregate,
        field): the constants of each field.  The reference's space also
        holds, per P1 node, functions that jump at every facet; with them
        the V-cycle stalls FGMRES on the rest-state SWE operator (ROADMAP
        C), so ``FlowSolver2d`` builds the per-field space.
    """

    def __init__(self, blocks, ring, mesh, target_size=None, fields=None):
        nc, _, d, _ = blocks.shape
        if target_size is None:
            # cap the coarse dimension at ~4096 (dense inverse 67 MB in
            # f32) while the aggregate diameter grows with the mesh
            target_size = max(48, int(np.ceil(nc * d / 4096.0)))
        agg, n_agg = aggregate_cells(mesh, target_size)
        self.n_agg = n_agg
        self.d = d
        b_np = blocks.detach().to("cpu", torch.float64).numpy()
        ring_np = np.asarray(ring)
        A_c = np.zeros((n_agg, d, n_agg, d))
        # A_c[I, :, J, :] += blocks[c, s] for agg[c] = I, agg[ring[c,s]] = J
        np.add.at(A_c, (agg[:, None], slice(None), agg[ring_np]), b_np)
        self.F = None
        if fields is not None:
            fields = np.asarray(fields)
            F = (fields[:, None] == np.arange(fields.max() + 1)).astype(
                np.float64)                                  # (d, nf)
            A_c = np.einsum("kf,IkJl,lg->IfJg", F, A_c, F, optimize=True)
            self.F = torch.as_tensor(F, dtype=blocks.dtype,
                                     device=blocks.device)
        self.nd_c = A_c.shape[1]
        A_c = A_c.reshape(n_agg * self.nd_c, n_agg * self.nd_c)
        self.agg = torch.as_tensor(agg.astype(np.int64), device=blocks.device)
        self.segments = aggregate_segments(agg, n_agg, blocks.device)
        self.Ac_inv = torch.as_tensor(np.linalg.inv(A_c), dtype=blocks.dtype,
                                      device=blocks.device)

    def __call__(self, r):
        """r (nc, d) -> coarse-corrected increment (nc, d)."""
        r_c = restrict(r, self.segments)
        if self.F is not None:
            r_c = r_c @ self.F
        z_c = (self.Ac_inv @ r_c.reshape(-1)).reshape(self.n_agg, self.nd_c)
        z = z_c[self.agg]
        return z if self.F is None else z @ self.F.T

    def transpose(self):
        """The coarse correction of the TRANSPOSED operator, for the
        adjoint solve: ``(F^T P^T A P F)^T = F^T P^T A^T P F``, so only the
        coarse inverse is transposed (ref ``assembled.py:390-416``).
        Built once and cached."""
        cached = getattr(self, "_transposed", None)
        if cached is None:
            cached = _TransposedCoarse(self)
            self._transposed = cached
        return cached


class _TransposedCoarse(CoarseCorrection):
    """:class:`CoarseCorrection` with the transposed coarse inverse."""

    def __init__(self, coarse):
        self.n_agg, self.d, self.nd_c = coarse.n_agg, coarse.d, coarse.nd_c
        self.agg, self.segments, self.F = coarse.agg, coarse.segments, coarse.F
        self.Ac_inv = coarse.Ac_inv.T.contiguous()
        self._transposed = coarse


def _ring_solve_impl(blocks_T, ring, valid, b, diag_inv_T, rtol, restart,
                     max_cycles, coarse=None, stats=None):
    """FGMRES core on a component-major ring operator: ``b`` (nc, d) ->
    ``(x, rnorm, bnorm)`` with x (nc, d).  The Krylov vectors stay
    component-major ``(d, nc)`` flattened.

    Preconditioner: block-Jacobi (inverted diagonal blocks); with a
    ``coarse`` correction the multiplicative two-level V-cycle (smooth,
    coarse-correct, smooth); a coarse object with ``is_full_pc`` (the
    Schur fieldsplit) is applied as-is.  Coarse objects take and return
    cell-major (nc, d) vectors."""
    from .newton import _fgmres_flat

    _, d, _, nc = blocks_T.shape

    def mvT(xT):
        return ring_mv(blocks_T, xT.contiguous(), ring, valid)

    def bjac(rT):
        return block_diag_mv(diag_inv_T, rT.contiguous())

    def mv(v):
        return mvT(v.reshape(d, nc)).reshape(-1)

    if coarse is None:
        def M(v):
            return bjac(v.reshape(d, nc)).reshape(-1)
    elif getattr(coarse, "is_full_pc", False):
        def M(v):
            return coarse(v.reshape(d, nc).T).T.reshape(-1)
    else:
        def M(v):
            r = v.reshape(d, nc)
            z = bjac(r)
            z = z + coarse((r - mvT(z)).T).T
            z = z + bjac(r - mvT(z))
            return z.reshape(-1)

    x, rnorm, bnorm = _fgmres_flat(mv, b.T.reshape(-1), M, rtol, restart,
                                   max_cycles, stats)
    return x.reshape(d, nc).T, rnorm, bnorm


def _transposed_coarse(coarse):
    if coarse is None:
        return None
    transpose = getattr(coarse, "transpose", None)
    if transpose is None:
        raise NotImplementedError(
            f"the ring solve's adjoint needs the preconditioner of the "
            f"transposed operator, and {type(coarse).__name__} has no "
            "transpose()")
    return transpose()


class _RingSolve(torch.autograd.Function):
    """``dx = A^{-1} r0`` by :func:`_ring_solve_impl`, differentiable by
    the implicit function theorem (the reference's ``_ring_solve``
    ``custom_vjp``, ``thetis_tpu/solvers/assembled.py:572-623``).  The
    backward solves ``A^T lam = xbar`` with the same FGMRES, ring matvec
    and block-Jacobi kernels on the blocks of ``A^T``, the transposed
    diagonal inverse and the transposed coarse object, to ``rtol``
    against ``||xbar||``, and returns ``r0_bar = lam`` and ``blocks_bar[s,
    i, j, c] = -lam[c, i] dx[ring[c, s], j]`` (zero on invalid slots).
    ``out`` receives the forward's residual norm."""

    @staticmethod
    def forward(blocks_T, r0, ring, valid, diag_inv_T, rtol_eff, rtol,
                restart, max_cycles, coarse, stats, out):
        dx, rnorm, _ = _ring_solve_impl(
            blocks_T, ring, valid, r0, diag_inv_T, rtol_eff, restart,
            max_cycles, coarse=coarse, stats=stats)
        out["rnorm"] = rnorm
        return dx

    @staticmethod
    def setup_context(ctx, inputs, output):
        (blocks_T, _, ring, valid, diag_inv_T, _, rtol, restart,
         max_cycles, coarse, stats, _) = inputs
        ctx.save_for_backward(blocks_T, ring, valid, diag_inv_T, output)
        ctx.solve_args = (rtol, restart, max_cycles, coarse, stats)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, xbar):
        blocks_T, ring, valid, diag_inv_T, dx = ctx.saved_tensors
        rtol, restart, max_cycles, coarse, stats = ctx.solve_args
        rev = ring_reverse(ring, valid)
        if rev is None:
            raise ValueError("the ring solve's adjoint needs a closed ring "
                             "table (solvers.assembled.cell_ring)")
        astats = {}
        lam, _, _ = _ring_solve_impl(
            ring_transpose_T(blocks_T, ring, valid, rev), ring, valid,
            xbar.contiguous(), diag_inv_T.transpose(0, 1).contiguous(),
            float(rtol), restart, max_cycles,
            coarse=_transposed_coarse(coarse), stats=astats)
        if stats is not None:
            stats["adjoint_ksp_cycles"] = (stats.get("adjoint_ksp_cycles", 0)
                                           + astats.get("ksp_cycles", 0))
        xg = dx.T[:, ring.T.long()] * valid.T[None].to(dx.dtype)
        blocks_bar = -torch.einsum("ic,jsc->sijc", lam.T, xg)
        return (blocks_bar, lam) + (None,) * 10


def ring_gmres(blocks_T, ring, valid, b, x0=None, r0=None, rtol=1e-5,
               restart=24, max_cycles=4, coarse=None, stats=None):
    """Solve ``A x = b`` for a component-major assembled ring operator
    with restarted FGMRES, right-preconditioned by block-Jacobi (inverted
    diagonal blocks), optionally wrapped in a two-level V-cycle with a
    :class:`CoarseCorrection` or replaced by a full PC (``is_full_pc``),
    warm-started from ``x0`` (zero when None).

    The residual system ``A dx = r0`` is solved, with ``r0 = b - A x0``
    (computed here when the caller does not know it in closed form), the
    convergence target still anchored to ``||b||``, and ``x = x0 + dx``.
    Like the reference, a solve whose residual grew past ``1e4 ||b||``
    returns NaN (PETSc's divergence tolerance).  ``stats``, when given,
    collects ``ksp_cycles`` and ``ksp_rel_residual`` (and, after a
    backward pass, ``adjoint_ksp_cycles``).

    Differentiable: the solve of the residual system is a
    :class:`_RingSolve` over ``(blocks_T, r0)``; gradients reach ``x0``
    through ``x = x0 + dx`` and ``r0`` through its own construction (the
    matvec here, or the caller's closed form), by ordinary autograd (ref
    ``assembled.py:647-656``)."""
    tiny = torch.finfo(b.dtype).tiny
    with torch.no_grad():
        diag_inv_T = batched_inv_small_T(blocks_T[0])
    if x0 is None:
        x0 = torch.zeros_like(b)
    if r0 is None:
        r0 = b - ring_apply_T(blocks_T, x0, ring, valid)
    bnorm = float(torch.linalg.vector_norm(b.detach()))
    r0norm = float(torch.linalg.vector_norm(r0.detach()))
    out = {}
    dx = _RingSolve.apply(
        blocks_T, r0, ring, valid, diag_inv_T,
        float(rtol) * bnorm / max(r0norm, tiny), float(rtol), restart,
        max_cycles, coarse, stats, out)
    rnorm = out["rnorm"]
    x = x0 + dx
    if stats is not None:
        stats["ksp_rel_residual"] = rnorm / max(bnorm, tiny)
    if rnorm > 1e4 * max(bnorm, tiny):
        x = torch.where(torch.ones((), dtype=torch.bool, device=x.device),
                        torch.full_like(x, float("nan")), x)
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


class AssembledWavePC:
    r"""Approximate inverse of the theta-weighted implicit SWE system,
    applied through assembled 1-ring blocks of the wave Jacobian

        W = d/du [ M u - theta dt R_wave(u) ],   R_wave = EPG + HUDiv

    linearized about ``lin_state`` (typically the rest state) and built
    ONCE at setup by colour probing.  ``__call__`` runs a fixed number of
    block-Jacobi right-preconditioned GMRES iterations on ``W x = r``
    (:func:`~.newton.fixed_gmres`): per iteration one ring matvec and one
    block-Jacobi apply (the two kernels), no host sync.

    The blocks are stored component-major ``Wb (4, 9, 9, nc)`` and the
    inverted diagonal blocks ``Wdiag_inv (9, 9, nc)``, in the packed dof
    order ``[uv (6), elev (3)]`` of the reference; vectors inside the
    solve are component-major ``(9, nc)``.

    :arg eq: ShallowWaterEquations-like object (EPG/HUDiv term names,
        ``mass_term``, the P1DG assembler)
    :arg lin_state: solution dict to linearize about
    :arg inner_iterations: GMRES iteration count of the W solve
    """

    def __init__(self, eq, dt, theta, lin_state, fields=None,
                 bnd_values=None, inner_iterations=20):
        self.eq = eq
        self.coeff = float(theta) * float(dt)
        self.n_inner = int(inner_iterations)
        mesh = eq.mesh
        if eq.asm.ndofs != 3:
            raise NotImplementedError(
                "assembled wave PC supports P1DG (3-dof) cells; use the "
                "matrix-free WaveEquationSchurPC for other elements")
        fields = fields or {}
        if bnd_values is None:
            # zero-valued boundary data with the equation's static BC-key
            # structure (values only shift the affine part)
            bnd_values = {m: {k: 0.0 for k in keys}
                          for m, keys in getattr(eq, "bnd_keys", {}).items()}
        ring_np, valid_np, colors = get_coloring(mesh)
        n_colors = int(colors.max()) + 1
        nc = ring_np.shape[0]
        self.nc = nc
        self.ring, self.valid = ring_tables(mesh)
        x0 = self._pack_cell(lin_state)
        c = self.coeff

        def wave_system(x):
            """F_wave(u) = M u - theta dt R_wave(u); solution_old fixed at
            the linearization state (the semi-implicit 'ksponly'
            linearization, ref ``timeintegrator.py:186-211``)."""
            st = {"uv": x[:, :6].reshape(nc, 3, 2), "elev": x[:, 6:]}
            r = eq.residual(_WAVE, st, lin_state, fields, fields, bnd_values)
            m = eq.mass_term(st)
            return self._pack_cell({"uv": m["uv"] - c * r["uv"],
                                    "elev": m["elev"] - c * r["elev"]})

        def W(v):
            return torch.func.jvp(wave_system, (x0,), (v,))[1]

        blocks = assemble_ring_blocks(W, 9, 9, ring_np, valid_np, colors,
                                      n_colors, nc, x0.dtype, x0.device,
                                      chunk_size=9)
        self.Wb = cell_to_T(blocks)
        del blocks
        # block-Jacobi: the slot-0 blocks inverted in float64
        self.Wdiag_inv = torch.linalg.inv(
            self.Wb[0].permute(2, 0, 1).to(torch.float64)).to(
            x0.dtype).permute(1, 2, 0).contiguous()

    @staticmethod
    def _pack_cell(st):
        nc = st["elev"].shape[0]
        return torch.cat([st["uv"].reshape(nc, 6), st["elev"]], dim=-1)

    # -- operator applications (component-major (9, nc)) -----------------
    def _W(self, xT):
        return ring_mv(self.Wb, xT.contiguous(), self.ring, self.valid)

    def _bjac(self, rT):
        return block_diag_mv(self.Wdiag_inv, rT.contiguous())

    def _solve(self, bT):
        """Fixed-iteration non-restarted GMRES on ``W x = b``, right-
        preconditioned with block-Jacobi (cf. PETSc gmres+bjacobi)."""
        from .newton import fixed_gmres

        nc = self.nc
        x = fixed_gmres(lambda v: self._W(v.reshape(9, nc)).reshape(-1),
                        lambda v: self._bjac(v.reshape(9, nc)).reshape(-1),
                        bT.reshape(-1), self.n_inner)
        return x.reshape(9, nc)

    # -- the preconditioner ----------------------------------------------
    def __call__(self, r):
        nc = self.nc
        bT = torch.cat([r["uv"].reshape(nc, 6).T, r["elev"].T]).contiguous()
        x = self._solve(bT)
        return {"uv": x[:6].T.reshape(nc, 3, 2), "elev": x[6:].T}

    def transpose(self):
        """The same preconditioner for the transposed system ``W^T``, for
        the Newton solve's adjoint (``J^T lam = g``): the blocks of
        ``W^T`` over the same ring table and the transposed diagonal
        inverse.  ``W`` itself preconditions ``J^T`` badly (the wave
        coupling's off-diagonal blocks are not symmetric): reused there,
        as the reference does, FGMRES stalls (ROADMAP C).  Built once and
        cached."""
        cached = getattr(self, "_transposed", None)
        if cached is None:
            cached = copy.copy(self)
            cached.Wb = ring_transpose_T(
                self.Wb, self.ring, self.valid,
                ring_reverse(self.ring, self.valid))
            cached.Wdiag_inv = self.Wdiag_inv.transpose(0, 1).contiguous()
            cached._transposed = self
            self._transposed = cached
        return cached
