r"""Lowest-order Brezzi-Douglas-Marini space BDM1 on triangles (port of
``thetis_tpu/fem/bdm.py``).

The reference's ``bdm-dg`` family (ref ``solver2d.py:329-336``) pairs a
BDM H(div) velocity with DG elevation; this is the lowest-order member
**BDM1 x P0**.  BDM1 is the full vector-P1 space (6 dofs a cell) with
H(div) conformity imposed through the facet dofs: the normal component is
*linear* along each facet, and the two dofs of a facet are its values at
the facet's endpoints (in the facet's global vertex order), shared
between the adjacent cells.

The basis is built numerically per cell: tangent vector-P1 functions
``v(xi) = J w(xi)`` (``w`` a 2-vector of P1 polynomials on the reference
triangle, ``J`` the (gdim, 2) cell Jacobian, tangent-plane valued on a
sphere), with coefficients solving the 6x6 dof system ``psi_k . n_f
(endpoint) = delta``.  Divergence and gradient are cell constants through
the planar pseudo-inverse ``J^+``.

Dof layout: ``(nf, 2)``, the normal velocity at the two endpoints of each
facet along its global normal.
"""
import numpy as np
import torch

from .reference_element import ReferenceElement
from .rt import HdivSpace, hdiv_jacobian

__all__ = ["BDMSpace"]


def _w_eval(xi):
    """(..., 2) reference points -> (..., 6, 2) monomials ``e_comp *
    {1, xi1, xi2}``."""
    one = np.ones_like(xi[..., 0])
    polys = np.stack([one, xi[..., 0], xi[..., 1]], axis=-1)
    out = np.zeros(xi.shape[:-1] + (6, 2))
    out[..., 0:3, 0] = polys
    out[..., 3:6, 1] = polys
    return out


class BDMSpace(HdivSpace):
    """Lowest-order BDM function space + assembler over a Mesh2d or a
    SphereMesh; the :class:`~thetis_tpu_torch.fem.rt.RTSpace` API."""

    family = "BDM"
    degree = 1
    PCG_ITERATIONS = 40

    def __init__(self, mesh, asm):
        self.mesh = mesh
        self.asm = asm
        nc, nf = mesh.nc, mesh.nf

        cells = mesh.cells_np
        cf = mesh.cell_facets_np                   # (nc, 3)
        fverts = mesh.facet_verts_np               # (nf, 2) global order
        nrm = mesh.facet_normal_np                 # (nf, gdim)
        self.gdim = gdim = mesh.coords_np.shape[1]
        tab = asm.space._tab_np
        ref_v = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        qp = np.asarray(tab["qp"])
        qt = np.asarray(tab["qt"])

        J = hdiv_jacobian(mesh)                    # (nc, gdim, 2)
        JtJ = np.einsum("cik,cil->ckl", J, J)
        Jpinv = np.einsum("ckl,cil->cki", np.linalg.inv(JtJ), J)

        # dof points: the endpoints of each local facet (global order),
        # located in the cell's reference coordinates by vertex id
        dof_ref = np.zeros((nc, 3, 2, 2))
        dof_n = np.zeros((nc, 3, 2, gdim))
        for i in range(3):
            fids = cf[:, i]
            for e in range(2):
                gv = fverts[fids, e]
                loc_idx = np.argmax(cells == gv[:, None], axis=1)
                dof_ref[:, i, e] = ref_v[loc_idx]
                dof_n[:, i, e] = nrm[fids]
        dof_ref = dof_ref.reshape(nc, 6, 2)
        dof_n = dof_n.reshape(nc, 6, gdim)

        # D[c, j, m] = (J w_m(xi_j)) . n_j; psi_k = sum_m C[m, k] J w_m
        Jw = np.einsum("cik,cjmk->cjmi", J, _w_eval(dof_ref))
        C = np.linalg.inv(np.einsum("cjmi,cji->cjm", Jw, dof_n))
        psi_q = np.einsum("cik,qmk,cmj->cjqi", J, _w_eval(qp), C)

        # constant gradients: grad psi_k = J (sum_m C[m,k] dw_m) J^+
        dw = np.zeros((6, 2, 2))                   # (mono, comp, dxi)
        dw[1, 0, 0] = dw[2, 0, 1] = dw[4, 1, 0] = dw[5, 1, 1] = 1.0
        dwk = np.einsum("mkl,cmj->cjkl", dw, C)
        grad = np.einsum("cik,cjkl,clh->cjih", J, dwk, Jpinv)
        self.grad_np = grad                        # (nc, 6, gdim, gdim)
        self.div_np = np.einsum("cjii->cj", grad)  # (nc, 6)

        # facet traces of the 6 basis functions from each side:
        # (nf, 2, nqf, 6, gdim)
        variant = mesh.facet_variant_np
        fcells = mesh.facet_cells_np
        ref_fpts = ReferenceElement.facet_points(qt)
        tr = np.zeros((nf, 2, len(qt), 6, gdim))
        for side in range(2):
            c = fcells[:, side]
            wf = _w_eval(ref_fpts[variant[:, side]])   # (nf, nqf, 6, 2)
            tr[:, side] = np.einsum("fik,fqmk,fmj->fqji", J[c], wf, C[c])

        # dof scatter: cell local dof j = (i, e) -> facet dof cf[c,i]*2 + e
        self.cell_facets_np = cf
        dofs = (np.repeat(cf, 2, axis=1) * 2
                + np.tile(np.array([0, 1]), (nc, 3))).astype(np.int64)
        self.sigma_np = np.where(mesh.cell_sides_np == 0, 1.0, -1.0)
        self._set_tables(dofs, psi_q, tr, (nf, 2))

        dev, dt = mesh.device, mesh.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        self.div = f(self.div_np)
        self.grad = f(grad)
        # the normal trace of each basis on its own facet at the facet
        # quad points: the endpoint hats, psi_(f,e) . n_f = hat_e
        self._own_trace = f(np.stack([1.0 - qt, qt], axis=-1))  # (nqf, 2)

    def project_vector(self, value):
        """U[f, e] = u(endpoint_e) . n_f (exact for BDM1 fields):
        ``value`` a constant vector, a CG1 vector (nv, gdim) or ready
        dofs (nf, 2)."""
        mesh = self.mesh
        nrm = mesh.facet_normal
        value = torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device)
        fv = mesh.facet_verts
        if value.dim() <= 1 and tuple(value.shape) != (mesh.nf,):
            un = (value.expand(mesh.nf, self.gdim) * nrm).sum(-1)
            return torch.stack([un, un], dim=-1)
        if value.dim() == 2 and value.shape[0] == mesh.nv:
            return torch.stack([(value[fv[:, 0]] * nrm).sum(-1),
                                (value[fv[:, 1]] * nrm).sum(-1)], dim=-1)
        if tuple(value.shape) == (mesh.nf, 2):
            # with gdim 2 a vector per facet has this shape too: taken as
            # dofs, as the reference does
            return value
        raise ValueError(
            f"cannot project {tuple(value.shape)} onto BDM dofs")

    # -- evaluation -----------------------------------------------------
    def cell_div(self, U):
        return (self._cell_dofs(U) * self.div).sum(dim=1)

    def facet_un_mean(self, U):
        """Mean normal velocity per facet (the exact flux density of the
        linear normal trace)."""
        return U.mean(dim=-1)

    def facet_un_quad(self, U):
        """Normal velocity at facet quad points (nf, nqf)."""
        return torch.einsum("fe,qe->fq", U, self._own_trace)

    # -- projections ----------------------------------------------------
    def div_to_dofs(self, Sq):
        cell_int = (self.wdetJ * Sq).sum(-1)
        return self._scatter(cell_int[:, None] * self.div)

    def grad_to_dofs(self, Gq):
        """Tensor integrand (nc, nq, gdim, gdim) against grad(psi)
        (constant in the cell)."""
        wG = (self.wdetJ[..., None, None] * Gq).sum(1)    # (nc, gdim, gdim)
        return self._scatter((wG[:, None] * self.grad).sum((2, 3)))

    def bnd_normal_to_dofs(self, Fq):
        """Boundary term: integrand (nf, nqf) against the own-facet
        normal trace (the endpoint hats), on the facet's own dofs; the
        caller masks to boundary facets."""
        return torch.einsum("fq,qe->fe", self.wlen * Fq, self._own_trace)
