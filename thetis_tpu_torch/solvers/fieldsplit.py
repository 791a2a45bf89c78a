r"""Schur-complement fieldsplit preconditioner on assembled ring blocks
(port of ``thetis_tpu/solvers/fieldsplit.py``).

The analogue of the reference's fieldsplit/Schur KSP configuration for
the implicit SWE system (ref ``options.py:44-48``): the velocity-
eliminated elevation Schur complement

    S = A_ee - A_eu diag(A_uu)^{-1} A_ue

is elliptic (a shifted DG Laplacian), where piecewise-constant
aggregation coarse spaces work; this class applies the full Schur
factorization

    z_u0  = Auu^{-1} r_u                (block-Jacobi-smoothed approx)
    z_eta = S^{-1} (r_eta - A_eu z_u0)  (fixed-iteration GMRES, two-level
                                         V-cycle preconditioner)
    z_u   = Auu^{-1} (r_u - A_ue z_eta)

as a complete preconditioner (``is_full_pc``) for the per-step assembled
KSP (``solvers/assembled.py::ring_gmres``), chosen by
``FlowSolver2d._build_coarse`` at large implicit wave CFL.

Setup is host-side (float64 numpy, scipy.sparse Galerkin triple product
for the coarse matrix) from the rest-state blocks, once per solver.  The
sub-blocks are 6x6, 6x3, 3x6 and 3x3; the reference applies them with
XLA gathers and contractions, not with a Pallas kernel, and so does the
port (gather + ``einsum``).  :meth:`SchurFieldsplitPC.transpose` is the
same PC built from the transposed blocks, for the ring solve's adjoint.
"""
import numpy as np
import torch

from ..kernels.ringmv import ring_reverse, ring_transpose_T
from .assembled import (aggregate_cells, aggregate_segments, restrict,
                        ring_apply, ring_tables)

__all__ = ["SchurFieldsplitPC"]


def _ring_to_csr(blocks, ring, p, q):
    """Host-side CSR of a 1-ring block operator (nc*p, nc*q)."""
    import scipy.sparse as sp

    nc = blocks.shape[0]
    ns = blocks.shape[1]
    rows = (np.arange(nc)[:, None, None, None] * p
            + np.arange(p)[None, None, :, None])
    cols = (ring[:, :, None, None] * q + np.arange(q)[None, None, None, :])
    rows = np.broadcast_to(rows, (nc, ns, p, q)).ravel()
    cols = np.broadcast_to(cols, (nc, ns, p, q)).ravel()
    return sp.coo_matrix(
        (np.asarray(blocks, dtype=np.float64).ravel(), (rows, cols)),
        shape=(nc * p, nc * q),
    ).tocsr()


def _rev_slots(ring):
    """rev[c, s] = slot of cell c inside ring[c, s]'s own ring."""
    nc = ring.shape[0]
    rr = ring[ring]  # (nc, 4, 4)
    return np.argmax(rr == np.arange(nc)[:, None, None], axis=-1)


class SchurFieldsplitPC:
    """Velocity-eliminated Schur fieldsplit on assembled ring blocks.

    :arg blocks: monolithic cell-major blocks (nc, 4, d, d) on the solve's
        device.  Packed layout per cell: ``[elev (d - n_u), uv (n_u)]``
        when ``eta_first`` (the ``PackedState`` order), else ``[uv,
        elev]``.
    :arg ring: (nc, 4) closed 1-ring table (host numpy)
    :arg mesh: mesh (for the coarse-space cell aggregation)
    :arg n_u: packed dofs belonging to the velocity block
    :arg u_smooth: extra block-Jacobi refinement sweeps per velocity
        solve (0 = pure block-diagonal inverse)
    :arg s_iters: fixed inner GMRES iterations for the S solve
    :arg coarse_cap: max coarse-space dimension (dense inverse)
    :arg eta_first: packed-dof layout
    """

    is_full_pc = True

    def __init__(self, blocks, ring, mesh, n_u=6, u_smooth=2, s_iters=8,
                 coarse_cap=2048, eta_first=True):
        import scipy.sparse as sp

        ring = np.asarray(ring)
        dev, dtype = blocks.device, blocks.dtype
        blocks_np = blocks.detach().to("cpu", torch.float64).numpy()
        nc, ns, d, _ = blocks_np.shape
        ne = d - n_u
        self.nc, self.n_u, self.ne = nc, n_u, ne
        self._mesh, self._coarse_cap = mesh, coarse_cap
        self._transposed = None
        self.u_smooth = int(u_smooth)
        self.s_iters = int(s_iters)
        self.eta_first = bool(eta_first)
        if eta_first:
            se, su = slice(0, ne), slice(ne, d)
        else:
            su, se = slice(0, n_u), slice(n_u, d)
        self._su, self._se = su, se

        Auu = blocks_np[:, :, su, su]
        Aue = blocks_np[:, :, su, se]
        Aeu = blocks_np[:, :, se, su]
        Aee = blocks_np[:, :, se, se]
        Duu_inv = np.linalg.inv(Auu[:, 0])

        # exact S diagonal blocks (for the Jacobi smoother):
        # S[c,c] = Aee[c,c] - sum_m Aeu[c,m] Duu_inv[m] Aue[m,c], with m
        # over the closed ring (the only cells coupling eta_c -> u -> eta_c)
        rev = _rev_slots(ring)
        Aue_back = Aue[ring, rev]          # (nc, 4, n_u, ne): u_{ring} <- eta_c
        Sdiag = Aee[:, 0] - np.einsum(
            "csem,csmn,csnf->cef", Aeu, Duu_inv[ring], Aue_back)
        Sdiag_inv = np.linalg.inv(Sdiag)

        # Galerkin coarse matrix of S via scipy sparse (setup only)
        S_sp = (_ring_to_csr(Aee, ring, ne, ne)
                - _ring_to_csr(Aeu, ring, ne, n_u)
                @ _ring_to_csr(Duu_inv[:, None], np.arange(nc)[:, None],
                               n_u, n_u)
                @ _ring_to_csr(Aue, ring, n_u, ne))
        target_size = max(16, int(np.ceil(nc * ne / float(coarse_cap))))
        agg, n_agg = aggregate_cells(mesh, target_size)
        P = sp.coo_matrix(
            (np.ones(nc * ne),
             (np.arange(nc * ne),
              (agg[:, None] * ne + np.arange(ne)[None, :]).ravel())),
            shape=(nc * ne, n_agg * ne),
        ).tocsr()
        A_c = (P.T @ S_sp @ P).toarray()
        self.n_agg = n_agg

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=dev)

        self.agg = t(agg.astype(np.int64), torch.int64)
        self.segments = aggregate_segments(agg, n_agg, dev)
        self.Ac_inv = t(np.linalg.inv(A_c))
        self.ring = t(ring.astype(np.int64), torch.int64)
        self.Auu, self.Aue = t(Auu), t(Aue)
        self.Aeu, self.Aee = t(Aeu), t(Aee)
        self.Duu_inv = t(Duu_inv)
        self.Sdiag_inv = t(Sdiag_inv)

    # ---- block applications ---------------------------------------------
    def _S(self, e):
        y = ring_apply(self.Aue, self.ring, e)
        y = torch.einsum("cij,cj->ci", self.Duu_inv, y)
        return (ring_apply(self.Aee, self.ring, e)
                - ring_apply(self.Aeu, self.ring, y))

    def _usolve(self, r):
        z = torch.einsum("cij,cj->ci", self.Duu_inv, r)
        for _ in range(self.u_smooth):
            z = z + torch.einsum(
                "cij,cj->ci", self.Duu_inv,
                r - ring_apply(self.Auu, self.ring, z))
        return z

    def _coarse(self, r):
        r_c = restrict(r, self.segments)
        z_c = (self.Ac_inv @ r_c.reshape(-1)).reshape(self.n_agg, self.ne)
        return z_c[self.agg]

    def _vcycle(self, r):
        """Multiplicative two-level V-cycle on S: Jacobi - coarse - Jacobi."""
        z = torch.einsum("cij,cj->ci", self.Sdiag_inv, r)
        r2 = r - self._S(z)
        z = z + self._coarse(r2)
        r3 = r - self._S(z)
        return z + torch.einsum("cij,cj->ci", self.Sdiag_inv, r3)

    def _ssolve(self, b):
        """Fixed-iteration non-restarted GMRES on S, V-cycle
        right-preconditioned (the outer KSP is FGMRES, so the fixed sweep
        being a nonlinear map is fine).  The breakdown guard is the
        scale-free one of :func:`~.newton.fixed_gmres`; the least squares
        stays on the device."""
        from .newton import fixed_gmres

        nc, ne = self.nc, self.ne
        x = fixed_gmres(lambda v: self._S(v.reshape(nc, ne)).reshape(-1),
                        lambda v: self._vcycle(v.reshape(nc, ne)).reshape(-1),
                        b.reshape(-1), self.s_iters)
        return x.reshape(nc, ne)

    # ---- the preconditioner ----------------------------------------------
    def __call__(self, r):
        """r (nc, d) -> z (nc, d): one full Schur-factorization sweep."""
        r_u, r_e = r[:, self._su], r[:, self._se]
        w_u = self._usolve(r_u)
        z_e = self._ssolve(r_e - ring_apply(self.Aeu, self.ring, w_u))
        z_u = self._usolve(r_u - ring_apply(self.Aue, self.ring, z_e))
        if self.eta_first:
            return torch.cat([z_e, z_u], dim=-1)
        return torch.cat([z_u, z_e], dim=-1)

    def transpose(self):
        """The PC of the transposed monolithic operator, for the ring
        solve's adjoint: the same construction from the transposed ring
        blocks, whose Schur complement is exactly ``S^T`` (ref
        ``fieldsplit.py:247-273``).  Built once and cached."""
        if self._transposed is None:
            d = self.n_u + self.ne
            su, se = self._su, self._se
            blocks = self.Auu.new_zeros((self.nc, self.ring.shape[1], d, d))
            blocks[:, :, su, su] = self.Auu
            blocks[:, :, su, se] = self.Aue
            blocks[:, :, se, su] = self.Aeu
            blocks[:, :, se, se] = self.Aee
            ring, valid = ring_tables(self._mesh)
            blocks_t = ring_transpose_T(blocks.permute(1, 2, 3, 0), ring,
                                        valid, ring_reverse(ring, valid))
            self._transposed = SchurFieldsplitPC(
                blocks_t.permute(3, 0, 1, 2), self.ring.cpu().numpy(),
                self._mesh, n_u=self.n_u,
                u_smooth=self.u_smooth, s_iters=self.s_iters,
                coarse_cap=self._coarse_cap, eta_first=self.eta_first)
            self._transposed._transposed = self
        return self._transposed
