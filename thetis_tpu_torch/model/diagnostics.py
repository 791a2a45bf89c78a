"""Field diagnostics (port of ``thetis_tpu/model/diagnostics.py``).

The reference's ``thetis/diagnostics.py``: the CG1 projector, the
vorticity, the gradient and Hessian recoverers (the latter two for the
inversion toolkit's Hessian regularisation), the kinetic energy,
``form2indicator`` and a dual-weighted-residual error indicator.

The consistent CG1 mass is solved by a few lumped-preconditioned
Richardson sweeps, as in the reference; everything is differentiable
(plain tensor operations) and stays on the fields' device.
"""
import numpy as np
import torch

from ..config import physical_constants

__all__ = ["P1Projector", "VorticityCalculator2D", "GradientRecoverer2D",
           "HessianRecoverer2D", "KineticEnergyCalculator",
           "form2indicator", "DWRErrorEstimator"]


class P1Projector:
    """L2 projection of cell-quadrature values into CG1 (ref
    ``diagnostics.py:28-59``)."""

    def __init__(self, asm):
        self.asm = asm
        mesh = asm.mesh
        self.mesh = mesh
        tab = asm.space._tab_np
        ml_cell = np.einsum("q,qd->d", tab["qw"], tab["phi"])
        lumped = np.zeros(mesh.nv)
        np.add.at(lumped, mesh.cells_np.ravel(),
                  (ml_cell[None, :] * mesh.detJ_np[:, None]).ravel())
        self._lumped_inv = asm.as_tensor(1.0 / lumped)
        self._cells = mesh.cells.reshape(-1)

    def _scatter(self, local):
        tail = local.shape[2:]
        return local.new_zeros((self.mesh.nv,) + tuple(tail)).index_add(
            0, self._cells, local.reshape((-1,) + tuple(tail)))

    def _mass_mv(self, x):
        return self._scatter(self.asm.mass_apply(x[self.mesh.cells]))

    def project(self, fq, iterations=6):
        """(nc, nq[, k...]) quad values -> (nv[, k...]) CG1 dof values."""
        b = self._scatter(self.asm.cell_to_dofs(fq))
        Ml = self._lumped_inv.reshape((-1,) + (1,) * (b.dim() - 1))
        x = Ml * b
        for _ in range(iterations):
            x = x + Ml * (b - self._mass_mv(x))
        return x


class VorticityCalculator2D:
    r"""omega = dv/dx - du/dy projected into CG1 (ref
    ``diagnostics.py:59-69``)."""

    def __init__(self, asm):
        self.asm = asm
        self.proj = P1Projector(asm)

    def solve(self, uv_dofs):
        g = self.asm.cell_grads(uv_dofs)  # (nc, nq, 2, 2) [k, i] du_k/dx_i
        return self.proj.project(g[..., 1, 0] - g[..., 0, 1])


class GradientRecoverer2D:
    """L2 gradient recovery into a CG1 vector (ref
    ``diagnostics.py:73-83``)."""

    def __init__(self, asm):
        self.asm = asm
        self.proj = P1Projector(asm)

    def solve(self, field_dofs):
        if field_dofs.shape[:1] == (self.asm.mesh.nv,):
            field_dofs = field_dofs[self.asm.mesh.cells]
        return self.proj.project(self.asm.cell_grads(field_dofs))


class HessianRecoverer2D:
    """Double L2 projection Hessian recovery (ref
    ``diagnostics.py:86-100``): gradient, then the gradient of the
    recovered gradient, symmetrised; returns (nv, 2, 2)."""

    def __init__(self, asm):
        self.asm = asm
        self.grad = GradientRecoverer2D(asm)

    def solve(self, field_dofs):
        g1 = self.grad.solve(field_dofs)                  # (nv, 2)
        H = self.asm.cell_grads(g1[self.asm.mesh.cells])  # (nc, nq, 2, 2)
        return self.grad.proj.project(0.5 * (H + H.transpose(-1, -2)))


class KineticEnergyCalculator:
    r"""E_kin = 0.5 rho int H |u|^2 (ref ``diagnostics.py:103-118``)."""

    def __init__(self, asm, depth, bathy_q, density=None):
        self.asm = asm
        self.depth = depth
        self.bathy_q = bathy_q
        self.density = density or physical_constants["rho0"]

    def compute(self, uv_dofs, elev_dofs):
        uv_q = self.asm.cell_values(uv_dofs)
        eta_q = self.asm.cell_values(elev_dofs)
        H_q = self.depth.total_depth(self.bathy_q, eta_q)
        e = 0.5 * self.density * H_q * (uv_q**2).sum(-1)
        return self.asm.integrate_cellq(e)


def form2indicator(asm, integrand_q):
    """Cell-wise contributions of a 0-form (ref ``diagnostics.py:
    120-128``): the integrand integrated over each cell.

    :arg integrand_q: (nc, nq) quadrature-point values of the integrand
    :returns: (nc,) per-cell indicator (a P0 field)
    """
    return (integrand_q * asm.wdetJ).sum(dim=1)


class DWRErrorEstimator:
    """Dual-weighted-residual error indicator for the 2D SWE (ref
    ``diagnostics.py:131-156``): eta_K = | <R(u), z> |_K, the weak
    residual paired cell by cell with an adjoint (weight) state."""

    def __init__(self, solver_obj):
        self.solver = solver_obj
        self.asm = solver_obj.asm
        self.eq = solver_obj.eq_sw

    def compute(self, state, adjoint_state, fields=None, bnd_values=None):
        """(state dict, adjoint dict with 'uv'/'elev') -> (nc,) indicator:
        the dof-space residual paired with the adjoint dofs per cell."""
        fields = fields or {}
        r = self.eq.residual("all", state, state, fields, fields,
                             bnd_values or {})
        pair_uv = (r["uv"] * adjoint_state["uv"]).sum(dim=(1, 2))
        pair_eta = (r["elev"] * adjoint_state["elev"]).sum(dim=1)
        return torch.abs(pair_uv + pair_eta)
