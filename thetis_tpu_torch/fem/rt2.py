r"""Degree-2 Raviart-Thomas space RT2 on planar triangles (port of
``thetis_tpu/fem/rt2.py``), and the assembler that RT2 and BDM2 share.

The reference's DEFAULT ``rt-dg`` member: ``get_functionspace`` builds
``RT(p+1) x P(p)DG`` and ``polynomial_degree`` defaults to 1, i.e.
**RT2 x P1DG** (ref ``thetis/utility.py:163-225``, ``solver2d.py:
307-336``).  :mod:`.rt` is the p = 0 member (RT1 x P0).

RT2 on a triangle is the 8-dimensional ``(P1)^2 + x Phom1``
(contravariant-Piola-mapped from the reference cell).  Its degrees of
freedom are nodal (any unisolvent set spans the same space):

* per facet, the normal component (linear along the facet) at the
  facet's two ENDPOINTS, in the facet's global vertex order and along its
  global normal, shared between the adjacent cells (H(div) conformity;
  the BDM1 convention);
* per cell, the two components of the cell-mean velocity.

Dof layout: flat ``(2*nf + 2*nc,)``, facet dofs first (``f*2 +
endpoint``), then cell dofs (``2*nf + c*2 + component``).

The basis is built per cell on the host (float64 numpy): physical
monomials ``v_m(x) = J w_m(xi) / detJ`` (contravariant Piola), the nodal
system solved by numpy; the quadrature tabulations are dense mesh-static
tables on the mesh's device; evaluation is gathers and contractions
(broadcast products and sums, as in :mod:`.rt`), projection a
scatter-add (``index_add``) onto the flat dofs.
"""
import numpy as np
import torch

from .reference_element import ReferenceElement
from .rt import HdivSpace, hdiv_jacobian, scatter_add

__all__ = ["RT2Space", "NodalHdivSpace"]

_REF_V = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def _w_eval(xi):
    """Reference monomials: (..., 2) points -> (..., 8, 2) values.

    m = 0..5: (P1)^2 = e_comp * {1, xi1, xi2}; m = 6, 7: xi * xi_k."""
    one = np.ones_like(xi[..., 0])
    polys = np.stack([one, xi[..., 0], xi[..., 1]], axis=-1)  # (..., 3)
    out = np.zeros(xi.shape[:-1] + (8, 2))
    out[..., 0:3, 0] = polys
    out[..., 3:6, 1] = polys
    out[..., 6, 0] = xi[..., 0] * xi[..., 0]
    out[..., 6, 1] = xi[..., 0] * xi[..., 1]
    out[..., 7, 0] = xi[..., 1] * xi[..., 0]
    out[..., 7, 1] = xi[..., 1] * xi[..., 1]
    return out


def _w_div(xi):
    """Reference divergence of the monomials: (..., 2) -> (..., 8)."""
    z = np.zeros_like(xi[..., 0])
    one = np.ones_like(z)
    return np.stack(
        [z, one, z, z, z, one, 3.0 * xi[..., 0], 3.0 * xi[..., 1]],
        axis=-1,
    )


def _w_grad(xi):
    """Reference gradients d w_m / d xi: (..., 2) -> (..., 8, 2, 2)
    with [..., m, i, j] = d w_m[i] / d xi_j."""
    shp = xi.shape[:-1]
    g = np.zeros(shp + (8, 2, 2))
    g[..., 1, 0, 0] = 1.0
    g[..., 2, 0, 1] = 1.0
    g[..., 4, 1, 0] = 1.0
    g[..., 5, 1, 1] = 1.0
    # w6 = (xi1^2, xi1 xi2)
    g[..., 6, 0, 0] = 2.0 * xi[..., 0]
    g[..., 6, 1, 0] = xi[..., 1]
    g[..., 6, 1, 1] = xi[..., 0]
    # w7 = (xi1 xi2, xi2^2)
    g[..., 7, 0, 0] = xi[..., 1]
    g[..., 7, 0, 1] = xi[..., 0]
    g[..., 7, 1, 1] = 2.0 * xi[..., 1]
    return g


class NodalHdivSpace(HdivSpace):
    """A planar H(div) space with nodal facet dofs (``n_facet`` a facet,
    along the facet's global normal) and ``n_cell`` interior dofs a cell,
    built from the reference monomials ``_w_eval``/``_w_div``/``_w_grad``
    and the nodal system of :meth:`_dof_system`: the tabulations,
    evaluation, projection and mass of RT2 and BDM2."""

    #: (family, degree, minimum quadrature degree, facet dofs, cell dofs,
    #: PCG iterations of the mass inverse): set by each space
    family = degree = None
    QUAD_DEGREE = N_FACET = N_CELL = PCG_ITERATIONS = None

    def __init__(self, mesh, asm):
        self.mesh = mesh
        self.asm = asm
        name = f"{self.family}{self.degree}"
        if asm.space.quad_degree < self.QUAD_DEGREE:
            # the basis products are quartic (and BDM2's bubble moment
            # quintic); a lower rule makes the quadrature Gram indefinite
            raise ValueError(
                f"{name} needs a paired DG space with quad_degree >= "
                f"{self.QUAD_DEGREE} (got {asm.space.quad_degree})")
        if mesh.coords_np.shape[1] != 2:
            raise NotImplementedError(
                f"{name} supports planar meshes (use the p = 0 spaces on "
                "manifolds)")
        nc, nf = mesh.nc, mesh.nf
        kf, kc = self.N_FACET, self.N_CELL
        self.n_facet_dofs = kf * nf
        cells, coords = mesh.cells_np, mesh.coords_np
        cf = mesh.cell_facets_np                      # (nc, 3)
        fverts = mesh.facet_verts_np                  # (nf, 2)
        nrm = mesh.facet_normal_np
        detJ = mesh.detJ_np
        tab = asm.space._tab_np
        qp = np.asarray(tab["qp"])
        qt = np.asarray(tab["qt"])
        w_q = np.asarray(tab["qw"])
        J = hdiv_jacobian(mesh)                       # (nc, 2, 2)
        Jinv = mesh.Jinv_np

        # the reference coordinates of each local facet's endpoints in the
        # GLOBAL facet order: local facet l runs (l+1)%3 -> (l+2)%3
        lverts = cells[:, [[1, 2], [2, 0], [0, 1]]]   # (nc, 3, 2)
        is_first = fverts[cf][..., 0] == lverts[..., 0]
        ends_ref = _REF_V[np.array([[1, 2], [2, 0], [0, 1]])]  # (3, 2, 2)
        e_ref = np.broadcast_to(ends_ref[None], (nc, 3, 2, 2)).copy()
        e_ref[~is_first] = e_ref[~is_first][:, ::-1]

        piola = detJ[:, None, None, None]
        v_qm = np.einsum("cij,qMj->cqMi", J, self._w_eval(qp)) / piola
        C = np.linalg.inv(self._dof_system(J, Jinv, detJ, e_ref, v_qm, qp,
                                           w_q, nrm[cf]))

        # --- tabulations of the nodal basis --------------------------------
        psi_q = np.einsum("cqMi,cMk->ckqi", v_qm, C)
        div_qm = self._w_div(qp)[None] / detJ[:, None, None]
        self.div_q_np = np.einsum("cqM,cMk->ckq", div_qm, C)
        # grad_x v_m = J gradxi(w_m) J^-1 / detJ
        g_qm = np.einsum("cij,qMjl,clk->cqMik", J, self._w_grad(qp),
                         Jinv) / piola[..., None]
        self.grad_q_np = np.einsum("cqMik,cMm->cmqik", g_qm, C)
        fcells = mesh.facet_cells_np
        variant = mesh.facet_variant_np
        ref_fpts = ReferenceElement.facet_points(qt)
        tr = np.zeros((nf, 2, len(qt), kf * 3 + kc, 2))
        for side in range(2):
            c = fcells[:, side]
            vp = np.einsum("fij,fqMj->fqMi", J[c],
                           self._w_eval(ref_fpts[variant[:, side]])) \
                / detJ[c][:, None, None, None]
            tr[:, side] = np.einsum("fqMi,fMk->fqki", vp, C[c])

        # --- global dof map (nc, 3 kf + kc) --------------------------------
        fmap = (cf[:, :, None] * kf
                + np.arange(kf)[None, None, :]).reshape(nc, 3 * kf)
        cmap = kf * nf + (np.arange(nc)[:, None] * kc
                          + np.arange(kc)[None, :])
        self.dofmap_np = np.concatenate([fmap, cmap], axis=1).astype(
            np.int64)

        # facet points of the nodal interpolation (seam-aware)
        a = coords[fverts[:, 0]]
        b = a + getattr(mesh, "_wrap_dx", lambda d: d)(
            coords[fverts[:, 1]] - a)
        self._fpts_np = self._facet_points(a, b)
        self._nrm_np = nrm

        self._set_tables(self.dofmap_np, psi_q, tr, (kf * nf + kc * nc,))
        dev, dt = mesh.device, mesh.dtype
        self.div_q = torch.as_tensor(self.div_q_np, dtype=dt, device=dev)
        self.grad_q = torch.as_tensor(self.grad_q_np, dtype=dt, device=dev)

    # -- Function compatibility -----------------------------------------
    def _as_dofs(self, value):
        """``value`` as this space's dofs: a tensor of the dof shape, or
        None when it is something else."""
        mesh = self.mesh
        value = torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device)
        return value if tuple(value.shape) == (self.ndofs,) else None

    @staticmethod
    def _host_call(value, x, y):
        """Evaluate a callable ``f(x, y) -> (..., 2)`` on host float64
        tensors (numpy and torch expressions both work); the result as
        numpy."""
        out = value(torch.as_tensor(x), torch.as_tensor(y))
        return np.asarray(out, dtype=np.float64)

    # -- evaluation ------------------------------------------------------
    def cell_div_q(self, U):
        """div(u) at cell quad points: (nc, nq)."""
        return (self._cell_dofs(U)[:, :, None] * self.div_q).sum(1)

    def facet_un_quad(self, U):
        """Normal velocity at facet quad points (single-valued by
        conformity; evaluated from side 0): (nf, nqf)."""
        U0 = U[self._facet_targets[:, 0]]                 # (nf, k)
        tr0 = (U0[:, None, :, None] * self.psi_tr[:, 0]).sum(2)
        return (tr0 * self.mesh.facet_normal[:, None, :]).sum(-1)

    # -- projection ------------------------------------------------------
    def div_to_dofs(self, Sq):
        """(nc, nq) scalar integrand against div(psi)."""
        wS = self.wdetJ * Sq                              # (nc, nq)
        return self._scatter((wS[:, None] * self.div_q).sum(2))

    def grad_to_dofs(self, Gq):
        """(nc, nq, 2, 2) tensor integrand against grad(psi)."""
        wG = self.wdetJ[..., None, None] * Gq             # (nc, nq, 2, 2)
        return self._scatter((wG[:, None] * self.grad_q).sum((2, 3, 4)))

    def bnd_normal_to_dofs(self, Fq):
        """(nf, nqf) scalar integrand against psi.n of the side-0 cell
        (the caller masks to boundary facets)."""
        n = self.mesh.facet_normal[:, None, None, :]
        psin = (self.psi_tr[:, 0] * n).sum(-1)          # (nf, nqf, k)
        loc = ((self.wlen * Fq)[..., None] * psin).sum(1)
        return scatter_add(self.ndofs, self._facet_targets[:, 0], loc)


class RT2Space(NodalHdivSpace):
    """RT2 function space + assembler over a planar Mesh2d.

    :arg asm: a P1DG :class:`~thetis_tpu_torch.fem.assembly.DGAssembler`
        whose quadrature rules are shared (so the paired elevation space
        evaluates coefficients at identical points); ``quad_degree >= 4``
    """

    family = "RT"
    degree = 2
    QUAD_DEGREE = 4
    N_FACET, N_CELL = 2, 2
    PCG_ITERATIONS = 40
    _w_eval = staticmethod(_w_eval)
    _w_div = staticmethod(_w_div)
    _w_grad = staticmethod(_w_grad)

    @staticmethod
    def _dof_system(J, Jinv, detJ, e_ref, v_qm, qp, w_q, n_cl):
        """D[c, k, m] = l_k(v_m): facet dofs k = l*2 + end, v . n at the
        endpoints; cell dofs the mean of each component."""
        nc = len(detJ)
        v_ends = np.einsum("cij,cleMj->cleMi", J, _w_eval(e_ref)) \
            / detJ[:, None, None, None, None]
        D_f = np.einsum("cleMi,cli->cleM", v_ends, n_cl)   # (nc, 3, 2, 8)
        # mean over the cell: int v detJ dxi / (A = detJ / 2)
        D_c = np.einsum("q,cqMi->ciM", w_q, v_qm) * 2.0     # (nc, 2, 8)
        return np.concatenate([D_f.reshape(nc, 6, 8), D_c], axis=1)

    @staticmethod
    def _facet_points(a, b):
        return np.stack([a, b], axis=1)                     # (nf, 2, 2)

    def project_vector(self, value):
        """Nodal interpolation: facet dofs v.n at the facet endpoints,
        cell dofs the cell-mean components.  ``value``: a constant (2,)
        vector, a callable ``f(x, y) -> (..., 2)`` (evaluated on the
        host in float64) or ready flat dofs."""
        mesh = self.mesh
        if callable(value):
            fp = self._fpts_np
            vf = self._host_call(value, fp[..., 0], fp[..., 1])  # (nf,2,2)
            fd = np.einsum("fei,fi->fe", vf, self._nrm_np)
            mid = mesh.coords_np[mesh.cells_np].mean(axis=1)
            vc = self._host_call(value, mid[:, 0], mid[:, 1])   # (nc, 2)
            return torch.as_tensor(np.concatenate([fd.ravel(), vc.ravel()]),
                                   dtype=mesh.dtype, device=mesh.device)
        dofs = self._as_dofs(value)
        if dofs is not None:
            return dofs
        value = torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device)
        if tuple(value.shape) == (2,):  # constant vector
            un = (value * mesh.facet_normal).sum(-1)
            fd = torch.stack([un, un], dim=-1)
            return torch.cat([fd.reshape(-1),
                              value.expand(mesh.nc, 2).reshape(-1)])
        raise ValueError(
            f"cannot project {tuple(value.shape)} onto RT2 dofs")
