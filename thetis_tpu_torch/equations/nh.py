r"""Depth-integrated non-hydrostatic (NH) pressure model.

Port of ``thetis_tpu/equations/nh.py``:

* :class:`DepthIntegratedPoissonSolver`: the elliptic solve for the NH
  pressure ``q`` and the velocity updates (ref ``utility.py:999-1105``),

  .. math::
     \nabla\cdot\nabla q + A\cdot\nabla q + B q + C = 0,\qquad
     A = \frac{\nabla(\eta - d)}{H},\quad
     C = -\frac{2\rho_0}{\Delta t}\Big(\nabla\cdot\bar u
         + 2\frac{\bar w - w_b}{H}\Big)

  assembled matrix-free on the CG q space (P2 by default: vertex dofs,
  then one dof per facet; a scatter-add over the cell node map) and
  solved by Jacobi-preconditioned BiCGStab (:func:`bicgstab`, the update
  formulas and stop test of ``jax.scipy.sparse.linalg.bicgstab``);
* :class:`FreeSurfaceEquation2D`: the eta-only continuity equation of
  the free-surface corrector (ref ``shallowwater_eq.py:969-997``), with
  the coupled continuity term's Riemann interface flux and a frozen
  velocity.

The serial NH advance of the model (ref
``coupled_timeintegrator_2d.py:161-236``): SWE step -> Poisson solve for
q -> uv/w update -> free-surface corrector re-advancing ``elev`` from the
pre-step value with the mid-point velocity.
"""
import numpy as np
import torch

from ..config import physical_constants
from .base import EquationBase, facet_quad_value, facet_quad_value_2s

__all__ = ["DepthIntegratedPoissonSolver", "FreeSurfaceEquation2D",
           "bicgstab"]


def bicgstab(A, b, x0, tol, atol, maxiter, M):
    """Preconditioned BiCGStab on flat tensors with the update formulas,
    early exit and stop test of ``jax.scipy.sparse.linalg.bicgstab``:
    iterate while ``||r||^2 > max(tol^2 ||b||^2, atol^2)``, at most
    ``maxiter`` times, stopping at a breakdown (rho, alpha or omega 0).

    Returns ``(x, iterations)``; the scalars are read on the host once an
    iteration (the reference's ``lax.while_loop`` condition)."""
    bs = float((b * b).sum())
    atol2 = max(tol * tol * bs, atol * atol)
    r = b - A(x0)
    x, rhat, p, q = x0, r, r, r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while float((r * r).sum()) > atol2 and k < maxiter:
        rho_ = (rhat * r).sum()
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / (rhat * q).sum()
        s = r - alpha * q
        exit_early = (s * s).sum() < atol2
        shat = M(s)
        t = A(shat)
        omega = (t * s).sum() / (t * t).sum()
        x = torch.where(exit_early, x + alpha * phat,
                        x + alpha * phat + omega * shat)
        r = torch.where(exit_early, s, s - omega * t)
        rho = rho_
        k += 1
        if bool((omega == 0) | (alpha == 0) | (rho_ == 0)):
            break
    return x, k


class DepthIntegratedPoissonSolver:
    """Matrix-free CG Poisson solve for the NH pressure q and the velocity
    updates (ref ``utility.py:999-1105``).  q lives in CG P2 by default
    (``q_degree = 2``): the P1DG-velocity / P2-pressure pair is the
    compatible one."""

    def __init__(self, mesh, asm, depth, dt, bnd_conditions=None,
                 rtol=1e-8, maxiter=200, q_degree=2):
        from ..fem.functionspace import FunctionSpace

        self.mesh = mesh
        self.asm = asm
        self.depth = depth
        self.dt = float(dt)
        self.rtol = rtol
        self.maxiter = maxiter
        self.rho0 = float(physical_constants["rho0"])
        #: BiCGStab iterations of the last solve
        self.iterations = 0

        self.q_space = FunctionSpace(mesh, "CG", q_degree,
                                     quad_degree=2 * q_degree + 1)
        qs = self.q_space
        tab = qs._tab_np
        qp = np.asarray(tab["qp"])                            # (nq, 2)
        dev = asm.as_tensor
        self.phi = dev(tab["phi"])                            # (nq, ndq)
        Jinv = np.asarray(mesh.Jinv_np)
        gph = np.einsum("qdj,cji->cqdi", np.asarray(tab["dphi"]), Jinv)
        self.gphi = dev(gph)                                  # (nc,nq,ndq,2)
        wdetJ = np.asarray(tab["qw"])[None, :] * mesh.detJ_np[:, None]
        self.wdetJ = dev(wdetJ)
        self.cnm = qs.cell_node_map                           # (nc, ndq)
        self._cnm_flat = self.cnm.reshape(-1)
        self.nq_nodes = qs.node_count
        # P1 (barycentric) tabulation at the q-space quad points, for the
        # DG1/CG1 coefficient fields (eta, uv, bathymetry)
        p1 = np.stack([1.0 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]],
                      axis=1)
        self.p1tab = dev(p1)                                  # (nq, 3)
        gp1 = np.asarray([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        self.gp1 = dev(np.einsum("dj,cji->cdi", gp1, Jinv))
        self.cells = mesh.cells
        # the L2 projection onto P1DG with the q-space quadrature
        self._Minv = dev(np.linalg.inv(np.einsum("qd,qe,q->de", p1, p1,
                                                 np.asarray(tab["qw"]))))

        # Dirichlet (q = 0) on the open boundaries that carry BC data
        # (ref utility.py:1060-1070): vertex and facet-midpoint dofs
        marker = mesh.facet_marker_np
        is_bnd = mesh.facet_is_boundary_np
        dmask = np.zeros(qs.node_count, dtype=bool)
        fverts = np.asarray(mesh.facet_verts_np)
        for m in (bnd_conditions or {}):
            sel = is_bnd & (marker == int(m))
            dmask[fverts[sel].ravel()] = True
            if q_degree == 2:
                dmask[mesh.nv + np.nonzero(sel)[0]] = True
        self.dirichlet = torch.as_tensor(dmask, device=mesh.device)

        # Jacobi preconditioner: the exact stiffness diagonal
        kdiag = np.einsum("cqdi,cqdi,cq->cd", gph, gph, wdetJ)
        diag = np.zeros(qs.node_count)
        np.add.at(diag, np.asarray(qs.cell_node_map_np).ravel(),
                  kdiag.ravel())
        self._diag = dev(np.maximum(diag, 1e-30))

    # -- helpers ----------------------------------------------------------
    def _q_values(self, v):
        """q-space dofs -> (nc, nq) quad values."""
        return torch.einsum("qd,cd->cq", self.phi, v[self.cnm])

    def _q_grads(self, v):
        """q-space dofs -> (nc, nq, 2) quad-point gradients."""
        return torch.einsum("cqdi,cd->cqi", self.gphi, v[self.cnm])

    def _p1_values(self, v_cellnodes):
        """(nc, 3[, k]) P1 cell-node values -> (nc, nq[, k])."""
        return torch.einsum("qd,cd...->cq...", self.p1tab, v_cellnodes)

    def _p1_grad(self, v_cellnodes):
        """(nc, 3) P1 cell-node values -> (nc, 2) cell-constant grads."""
        return torch.einsum("cdi,cd->ci", self.gp1, v_cellnodes)

    def _scatter(self, cell_acc, grad_acc_q):
        """Project quad accumulators onto the q-space test functions:
        cell_acc (nc, nq), grad_acc_q (nc, nq, 2) -> (n_nodes,)."""
        local = torch.einsum("cq,qd->cd", cell_acc * self.wdetJ, self.phi)
        if grad_acc_q is not None:
            local = local + torch.einsum("cqi,cq,cqdi->cd", grad_acc_q,
                                         self.wdetJ, self.gphi)
        return local.new_zeros(self.nq_nodes).index_add(
            0, self._cnm_flat, local.reshape(-1))

    def _operator_parts(self, elev_dofs, bathy_v):
        """The q-independent coefficients at the q-space quad points."""
        eta_q = self._p1_values(elev_dofs)            # (nc, nq)
        bathy_cn = bathy_v[self.cells]                # (nc, 3)
        bathy_q = self._p1_values(bathy_cn)
        H_q = torch.clamp_min(eta_q + bathy_q, 0.05)
        geta = self._p1_grad(elev_dofs.reshape(elev_dofs.shape[0], 3))
        gbath = self._p1_grad(bathy_cn)
        return dict(H_q=H_q, ghori=geta - gbath, gH=geta + gbath)

    def _apply_A(self, q, parts):
        """Weak operator action (sign-flipped so the Laplacian is positive
        definite), the Dirichlet rows replaced by the identity."""
        zero = torch.zeros_like(q)
        qf = torch.where(self.dirichlet, zero, q)
        gq = self._q_grads(qf)                        # (nc, nq, 2)
        q_q = self._q_values(qf)                      # (nc, nq)
        H_q = parts["H_q"]
        ghori, gH = parts["ghori"], parts["gH"]
        gh = ghori[:, None, :]
        # f = -grad q . grad t
        grad_acc = -gq
        # f += (ghori/H . grad q) t
        cell_acc = (gh * gq).sum(-1) / H_q
        # f += -grad(q t / H) . ghori
        #    = -(t/H) grad q . ghori - (q/H) grad t . ghori
        #      + (q t / H^2) grad H . ghori
        cell_acc = cell_acc - (gq * gh).sum(-1) / H_q
        grad_acc = grad_acc - gh * (q_q / H_q)[..., None]
        cell_acc = cell_acc + q_q * (ghori * gH).sum(-1)[:, None] / H_q**2
        # f += -(ghori . grad H + 4)/H^2 q t
        cell_acc = cell_acc - (
            ((ghori * gH).sum(-1)[:, None] + 4.0) / H_q**2) * q_q
        r = self._scatter(cell_acc, grad_acc)
        return torch.where(self.dirichlet, q, -r)

    def _rhs(self, uv_dofs, w_dofs, parts, bathy_v):
        """C projected onto the test space (the sign of _apply_A)."""
        const = 2.0 * self.rho0 / self.dt
        uv_q = self._p1_values(uv_dofs)               # (nc, nq, 2)
        w_q = self._p1_values(w_dofs)                 # (nc, nq)
        gbath = self._p1_grad(bathy_v[self.cells])    # (nc, 2)
        w_b = -(uv_q * gbath[:, None, :]).sum(-1)     # -uv . grad d
        cell_acc = -const * 2.0 * (w_q - w_b) / parts["H_q"]
        c_vec = self._scatter(cell_acc, const * uv_q)
        return torch.where(self.dirichlet, torch.zeros_like(c_vec), c_vec)

    def _project(self, fq):
        """(nc, nq[, k]) quad values -> P1DG dofs (nc, 3[, k])."""
        rhs = torch.einsum("cq...,cq,qd->cd...", fq, self.wdetJ, self.p1tab)
        detJ = self.mesh.detJ[:, None] if fq.dim() == 2 else \
            self.mesh.detJ[:, None, None]
        return torch.einsum("de,ce...->cd...", self._Minv, rhs) / detJ

    def solve(self, uv_dofs, w_dofs, elev_dofs, bathy_v, q0=None):
        """Solve for q (n_nodes,) and return ``(q, uv_new, w_new)``; the
        BiCGStab iteration count is kept in :attr:`iterations`."""
        parts = self._operator_parts(elev_dofs, bathy_v)
        b = self._rhs(uv_dofs, w_dofs, parts, bathy_v)
        x0 = q0 if q0 is not None else torch.zeros_like(b)
        q, self.iterations = bicgstab(
            lambda x: self._apply_A(x, parts), b, x0, tol=self.rtol,
            atol=0.0, maxiter=self.maxiter, M=lambda x: x / self._diag)
        q = torch.where(self.dirichlet, torch.zeros_like(q), q)

        # velocity updates, L2-projected onto P1DG (ref
        # utility.py:1077-1099): uv -= dt/(2 rho0) (grad q + ghori/H q);
        # w += dt/rho0 q/H
        gq = self._q_grads(q)
        q_q = self._q_values(q)
        H_q = parts["H_q"]
        duv_q = -0.5 * self.dt / self.rho0 * (
            gq + parts["ghori"][:, None, :] * (q_q / H_q)[..., None])
        dw_q = self.dt / self.rho0 * q_q / H_q
        return q, uv_dofs + self._project(duv_q), w_dofs + self._project(dw_q)


class FreeSurfaceEquation2D(EquationBase):
    """eta-only continuity equation of the NH free-surface corrector (ref
    ``shallowwater_eq.py:969-997``): d(eta)/dt = -div(H uv) with a frozen
    velocity and the coupled continuity term's Riemann interface flux
    (``shallowwater_eq.py:396-450``)."""

    def __init__(self, mesh, asm, depth, bathymetry, bnd_conditions=None):
        super().__init__(mesh, asm, bnd_conditions)
        self.depth = depth
        self.g = float(physical_constants["g_grav"])
        b = asm.as_tensor(bathymetry)
        nq = len(asm.space._tab_np["qw"])
        self.bathy_q = (asm.cg1_values(b[mesh.cells]) if b.dim() == 1
                        else b.expand(mesh.nc, nq))
        self.bathy_tr = facet_quad_value_2s(asm, bathymetry)

    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        asm = self.asm
        eta = solution["elev"]
        uv_dofs = fields["uv_2d"]
        n = self.mesh.facet_normal[:, None, :]

        H_q = self.depth.total_depth(self.bathy_q, asm.cell_values(eta))
        B_grad = H_q[..., None] * asm.cell_values(uv_dofs)  # H uv . grad t

        # interior Riemann flux with the eta jump (frozen uv)
        eta_tr = asm.facet_traces(eta)
        uv_tr = asm.facet_traces(uv_dofs)
        H_tr = self.depth.total_depth(self.bathy_tr, eta_tr)
        h = 0.5 * (H_tr[:, 0] + H_tr[:, 1])
        uv_rie = 0.5 * (uv_tr[:, 0] + uv_tr[:, 1]) + (
            torch.sqrt(self.g / torch.clamp_min(torch.abs(h), 1e-12))
            * (eta_tr[:, 0] - eta_tr[:, 1]))[..., None] * n
        hu_star_n = h * (uv_rie * n).sum(-1)
        mi = self._mask_q(self.mask_int)
        B_facet = torch.stack([-hu_star_n, hu_star_n], dim=1) * mi[:, None]

        # open boundaries with an 'elev' BC: flux h_rie un with the
        # exterior elevation; other and land boundaries: no flux
        for m in self.open_markers:
            if "elev" not in self.bnd_keys.get(m, ()):
                continue
            mask = self._mask_q(self.marker_masks[m])
            eta_ext = facet_quad_value(asm, bnd_values[m]["elev"])
            H_b = H_tr[:, 0]
            un_b = (uv_tr[:, 0] * n).sum(-1)
            un_rie = un_b + torch.sqrt(
                self.g / torch.clamp_min(torch.abs(H_b), 1e-12)) * (
                    eta_tr[:, 0] - eta_ext)
            contrib = -H_b * un_rie * mask
            B_facet = B_facet + torch.stack(
                [contrib, torch.zeros_like(contrib)], dim=1)

        return {"elev": asm.grad_to_dofs(B_grad)
                + asm.facet_to_dofs(B_facet)}

    def mass_term(self, solution):
        return {"elev": self.asm.mass_apply(solution["elev"])}

    def mass_inverse(self, r):
        return {"elev": self.asm.mass_inverse(r["elev"])}
