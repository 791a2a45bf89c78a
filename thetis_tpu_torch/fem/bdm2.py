r"""Degree-2 Brezzi-Douglas-Marini space BDM2 on planar triangles (port of
``thetis_tpu/fem/bdm2.py``).

The reference's ``bdm-dg`` family at ``polynomial_degree = 1`` (ref
``solver2d.py:329-336``: ``U = BDM(p+1)``, ``H = P(p)DG``) pairs **BDM2 x
P1DG**.  BDM2 is the full 12-dimensional ``(P2)^2`` (contravariant-Piola
mapped); the normal component is quadratic along each facet.  Degrees of
freedom (nodal):

* per facet, v . n at THREE points, the two endpoints and the midpoint,
  in the facet's global vertex order along its global normal (9 a cell,
  shared between the adjacent cells: H(div) conformity);
* per cell, the two components of the cell-mean velocity and one
  interior moment ``int_T v . curl(b_T)`` against the cubic bubble ``b_T
  = lambda0 lambda1 lambda2`` (the standard BDM2 interior functional,
  which the mean alone cannot close).

Dof layout: flat ``(3*nf + 3*nc,)``, facet dofs first (``f*3 + point``),
then cell dofs (``3*nf + c*3 + k``).  Tabulation, evaluation, projection
and mass are :class:`~thetis_tpu_torch.fem.rt2.NodalHdivSpace`'s; the
paired DG assembler must carry ``quad_degree >= 5``.
"""
import numpy as np
import torch

from .rt2 import NodalHdivSpace

__all__ = ["BDM2Space"]

_R = np.array([[0.0, 1.0], [-1.0, 0.0]])  # 2D curl: c = R grad(b)


def _w_eval(xi):
    """(..., 2) -> (..., 12, 2): e_comp * {1, x, y, x^2, xy, y^2}."""
    x, y = xi[..., 0], xi[..., 1]
    one = np.ones_like(x)
    polys = np.stack([one, x, y, x * x, x * y, y * y], axis=-1)
    out = np.zeros(xi.shape[:-1] + (12, 2))
    out[..., 0:6, 0] = polys
    out[..., 6:12, 1] = polys
    return out


def _w_div(xi):
    """(..., 2) -> (..., 12) reference divergences."""
    x, y = xi[..., 0], xi[..., 1]
    z = np.zeros_like(x)
    one = np.ones_like(x)
    return np.stack(
        [z, one, z, 2 * x, y, z,
         z, z, one, z, x, 2 * y], axis=-1)


def _w_grad(xi):
    """(..., 2) -> (..., 12, 2, 2) with [..., m, i, j] = d w_m[i]/d xi_j."""
    x, y = xi[..., 0], xi[..., 1]
    shp = xi.shape[:-1]
    dp = np.zeros(shp + (6, 2))     # d polys / d xi
    dp[..., 1, 0] = 1.0
    dp[..., 2, 1] = 1.0
    dp[..., 3, 0] = 2 * x
    dp[..., 4, 0] = y
    dp[..., 4, 1] = x
    dp[..., 5, 1] = 2 * y
    g = np.zeros(shp + (12, 2, 2))
    g[..., 0:6, 0, :] = dp
    g[..., 6:12, 1, :] = dp
    return g


def _barycentric(qp):
    return np.stack([1 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]], axis=1)


class BDM2Space(NodalHdivSpace):
    """BDM2 function space + assembler over a planar Mesh2d (the
    :class:`~thetis_tpu_torch.fem.rt2.RT2Space` API)."""

    family = "BDM"
    degree = 2
    QUAD_DEGREE = 5
    N_FACET, N_CELL = 3, 3
    PCG_ITERATIONS = 50
    _w_eval = staticmethod(_w_eval)
    _w_div = staticmethod(_w_div)
    _w_grad = staticmethod(_w_grad)

    @staticmethod
    def _dof_system(J, Jinv, detJ, e_ref, v_qm, qp, w_q, n_cl):
        """Facet dofs: v . n at [end0, mid, end1] of each local facet in
        the global direction; cell dofs: the component means and the
        bubble-curl moment."""
        nc = len(detJ)
        mid_ref = e_ref.mean(axis=2, keepdims=True)          # (nc, 3, 1, 2)
        pts_ref = np.concatenate(
            [e_ref[:, :, :1], mid_ref, e_ref[:, :, 1:]], axis=2)
        v_p = np.einsum("cij,clpMj->clpMi", J, _w_eval(pts_ref)) \
            / detJ[:, None, None, None, None]
        D_f = np.einsum("clpMi,cli->clpM", v_p, n_cl)        # (nc,3,3,12)
        D_mean = np.einsum("q,cqMi->ciM", w_q, v_qm) * 2.0   # (nc, 2, 12)
        # bubble-curl moment: b = l0 l1 l2; c = R grad_x(b)
        lam = _barycentric(qp)
        dlam_ref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        gb_ref = (lam[:, 1] * lam[:, 2])[:, None] * dlam_ref[0] \
            + (lam[:, 0] * lam[:, 2])[:, None] * dlam_ref[1] \
            + (lam[:, 0] * lam[:, 1])[:, None] * dlam_ref[2]  # (nq, 2)
        gb_x = np.einsum("qj,cji->cqi", gb_ref, Jinv)
        c_q = np.einsum("ij,cqj->cqi", _R, gb_x)
        D_bub = np.einsum("q,c,cqi,cqMi->cM", w_q, detJ, c_q, v_qm)
        # normalize the bubble functional per cell (it scales like area/h
        # against the O(1) point/mean dofs; ~1e5 mass condition number
        # otherwise)
        D_bub = D_bub / np.linalg.norm(D_bub, axis=1, keepdims=True)
        return np.concatenate(
            [D_f.reshape(nc, 9, 12), D_mean, D_bub[:, None, :]], axis=1)

    @staticmethod
    def _facet_points(a, b):
        return np.stack([a, 0.5 * (a + b), b], axis=1)      # (nf, 3, 2)

    def project_vector(self, value):
        """Nodal interpolation: facet dofs v.n at [end0, mid, end1]; with
        those fixed, the 3 interior dofs a cell L2-match the field at the
        cell quadrature points (exact whenever v is in BDM2).  ``value``:
        a callable ``f(x, y) -> (..., 2)`` (evaluated on the host in
        float64), a constant (2,) vector or ready flat dofs."""
        mesh = self.mesh
        if callable(value):
            nf = mesh.nf
            fp = self._fpts_np
            vf = self._host_call(value, fp[..., 0], fp[..., 1])  # (nf,3,2)
            fd = np.einsum("fpi,fi->fp", vf, self._nrm_np)
            verts = mesh.coords_np[mesh.cells_np]
            lam = _barycentric(np.asarray(self.asm.space._tab_np["qp"]))
            xy = np.einsum("qd,cdi->cqi", lam, verts)
            vq = self._host_call(value, xy[..., 0], xy[..., 1])  # (nc,nq,2)
            U = np.zeros(self.ndofs)
            U[:3 * nf] = fd.ravel()
            psi = self.psi_q_np                                # (nc,12,nq,2)
            known = fd.reshape(-1)[self.dofmap_np[:, :9]]      # (nc, 9)
            r = vq - np.einsum("ck,ckqi->cqi", known, psi[:, :9])
            A = psi[:, 9:]
            G = np.einsum("cq,ckqi,clqi->ckl", self.wdetJ_np, A, A)
            b = np.einsum("cq,ckqi,cqi->ck", self.wdetJ_np, A, r)
            U[3 * nf:] = np.linalg.solve(G, b[:, :, None])[:, :, 0].ravel()
            return torch.as_tensor(U, dtype=mesh.dtype, device=mesh.device)
        dofs = self._as_dofs(value)
        if dofs is not None:
            return dofs
        v = np.asarray(torch.as_tensor(value, dtype=torch.float64).cpu())
        if v.shape == (2,):  # constant vector
            return self.project_vector(
                lambda x, y: np.stack([np.full(np.shape(x), v[0]),
                                       np.full(np.shape(x), v[1])],
                                      axis=-1))
        raise ValueError(f"cannot project {v.shape} onto BDM2 dofs")
