"""Field recovery by L2 projection into CG1 (part of
``thetis_tpu/model/diagnostics.py``): the projector and the gradient and
Hessian recoverers that the inversion toolkit's Hessian regularisation
uses.  The other diagnostics wait for ROADMAP A11.

The consistent CG1 mass is solved by a few lumped-preconditioned
Richardson sweeps, as in the reference; everything is differentiable
(plain tensor operations).
"""
import numpy as np
import torch

__all__ = ["P1Projector", "GradientRecoverer2D", "HessianRecoverer2D"]


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
