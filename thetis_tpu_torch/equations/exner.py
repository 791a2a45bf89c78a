r"""Exner bed-evolution equation.

Port of ``thetis_tpu/equations/exner.py`` (the reference's
``thetis/exner_eq.py``):

  ExnerSourceTerm         (ref L56-84)    source   suspended-load exchange
  ExnerBedloadTerm        (ref L87-129)   implicit Meyer-Peter-Mueller
                                                   bedload and its
                                                   open-boundary flux
  ExnerSedimentSlideTerm  (ref L132-150)  implicit slide diffusion

solved in the continuous (CG1) bathymetry space, the bed being the SWE's
bathymetry (positive downward).  The CG residual is a per-cell
integration followed by a scatter-add (``index_add``) over the cell ->
vertex map; the consistent CG mass system is inverted by exactly the
reference's 6 lumped-Jacobi Richardson iterations.
"""
import numpy as np
import torch

from .base import Bucket, EquationBase

__all__ = ["ExnerEquation"]


class ExnerEquation(EquationBase):
    #: lumped-Jacobi Richardson iterations of the consistent-mass inverse
    #: (ref ``exner_eq.py:170-182``); part of the scheme, not a tolerance
    MASS_ITERATIONS = 6

    def __init__(self, mesh, asm, cg_space, depth, sediment_model, options,
                 bnd_conditions=None, depth_integrated_sediment=False):
        super().__init__(mesh, asm, bnd_conditions)
        self.space = cg_space
        self.depth = depth
        self.sediment_model = sediment_model
        self.options = options
        self.depth_integrated_sediment = depth_integrated_sediment
        so = options.sediment_model_options
        self.fac = float(so.morphological_acceleration_factor) / (
            1.0 - float(so.porosity))
        self._cnm = cg_space.cell_node_map
        self._cnm_flat = self._cnm.reshape(-1)
        self._slide_region_q = None
        self.add_term("ExnerSourceTerm", "source", self._t_source)
        if so.use_bedload:
            self.add_term("ExnerBedloadTerm", "implicit", self._t_bedload)
        if so.use_sediment_slide:
            self.add_term("ExnerSedimentSlideTerm", "implicit",
                          self._t_slide)
            sr = so.slide_region
            if sr is not None:
                sr = asm.as_tensor(sr.data if hasattr(sr, "data") else sr)
                if tuple(sr.shape[:1]) == (mesh.nv,):
                    sr = sr[mesh.cells]
                self._slide_region_q = asm.cell_values(sr)

        # lumped CG mass (row sums of the consistent mass matrix)
        tab = asm.space._tab_np
        ml_cell = np.einsum("q,qd->d", tab["qw"], tab["phi"])
        lumped = np.zeros(cg_space.node_count)
        np.add.at(lumped, np.asarray(cg_space.cell_node_map_np).ravel(),
                  (ml_cell[None, :] * mesh.detJ_np[:, None]).ravel())
        self._lumped = asm.as_tensor(lumped)

    # -- CG assembly helpers ---------------------------------------------
    def _scatter(self, local):
        """(nc, nd) per-cell dof contributions -> (n_cg,)."""
        return local.new_zeros(self.space.node_count).index_add(
            0, self._cnm_flat, local.reshape(-1))

    def _cell_dofs(self, u):
        return u[self._cnm]

    # -- terms -------------------------------------------------------------
    def _ctx(self, solution, solution_old, fields):
        asm = self.asm
        c = {"fields": fields}
        c["uv_q"] = asm.cell_values(fields["uv_2d"])
        c["eta_q"] = asm.cell_values(fields["elev_2d"])
        zb_cell = self._cell_dofs(solution["bathymetry"])
        c["zb_cell"] = zb_cell
        c["H_q"] = self.depth.total_depth(asm.cell_values(zb_cell),
                                          c["eta_q"])
        c["grad_zb"] = asm.cell_grads(zb_cell)
        c["grad_zb_old"] = asm.cell_grads(
            self._cell_dofs(solution_old["bathymetry"]))
        return c

    def _t_source(self, c, B):
        """ref ``exner_eq.py:56-84``."""
        sed = c["fields"].get("sediment")
        if sed is None:
            return
        sed_q = self.asm.cell_values(sed) if sed.dim() >= 2 else sed
        m = self.sediment_model
        ero = m.get_erosion_term(c["uv_q"], c["H_q"])
        depo = m.get_deposition_coefficient(c["uv_q"], c["H_q"]) * sed_q
        if self.depth_integrated_sediment:
            depo = depo / c["H_q"]
        B["cell"].add(self.fac * (ero - depo))

    def _t_bedload(self, c, B):
        """ref ``exner_eq.py:87-129``: R = fac div(Qb) in the bed-depth
        convention; by parts the cell term tests fac Qb against
        grad(psi), and open boundaries add the outward flux (closed ones
        none), evaluated from side-0 traces."""
        m = self.sediment_model
        qbx, qby = m.get_bedload_term(c["uv_q"], c["H_q"], c["grad_zb_old"],
                                      c["grad_zb"])
        B["grad"].add(self.fac * torch.stack([qbx, qby], dim=-1))
        if not self.open_markers:
            return
        asm = self.asm
        uv_tr = asm.facet_traces(c["fields"]["uv_2d"])[:, 0]
        eta_tr = asm.facet_traces(c["fields"]["elev_2d"])[:, 0]
        # P1 gradients are cellwise constant: take the owner cell's
        gz_tr = c["grad_zb"][self.mesh.facet_cells[:, 0], :1, :]
        zb_tr = asm.facet_traces(c["zb_cell"])[:, 0]
        H_b = self.depth.total_depth(zb_tr, eta_tr)
        qbx_b, qby_b = m.get_bedload_term(uv_tr, H_b, gz_tr, gz_tr)
        n = self.mesh.facet_normal[:, None, :]
        qbn = qbx_b * n[..., 0] + qby_b * n[..., 1]
        contrib = -self.fac * qbn * self._mask_q(self.mask_open)
        B["facet"].add(torch.stack([contrib, torch.zeros_like(contrib)],
                                   dim=1))

    def _t_slide(self, c, B):
        """Sediment-slide bed diffusion (ref ``exner_eq.py:132-150``): the
        weak residual ``alphaconst grad(zb) . grad(test)`` with the
        non-positive slide coefficient of the sediment model; the
        reference's interior-penalty terms vanish on the continuous bed
        space."""
        alpha = self.sediment_model.get_sediment_slide_term(
            c["grad_zb_old"], self._slide_region_q)
        B["grad"].add(alpha[..., None] * c["grad_zb"])

    # -- interface -----------------------------------------------------------
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        c = self._ctx(solution, solution_old, fields)
        B = {"cell": Bucket(), "grad": Bucket(), "facet": Bucket()}
        for _, method in self.select_terms(label):
            method(c, B)
        asm = self.asm
        r = torch.zeros_like(solution["bathymetry"])
        if B["cell"]:
            r = r + self._scatter(asm.cell_to_dofs(B["cell"].val))
        if B["grad"]:
            r = r + self._scatter(asm.grad_to_dofs(B["grad"].val))
        if B["facet"]:
            r = r + self._scatter(asm.facet_to_dofs(B["facet"].val))
        return {"bathymetry": r}

    def _mass_mv(self, x):
        return self._scatter(self.asm.mass_apply(self._cell_dofs(x)))

    def mass_term(self, solution):
        return {"bathymetry": self._mass_mv(solution["bathymetry"])}

    def mass_inverse(self, r, iterations=MASS_ITERATIONS):
        """The consistent-mass solve by lumped-Jacobi Richardson
        iterations (ref ``exner_eq.py:170-182``)."""
        b = r["bathymetry"]
        Ml_inv = 1.0 / self._lumped
        x = Ml_inv * b
        for _ in range(iterations):
            x = x + Ml_inv * (b - self._mass_mv(x))
        return {"bathymetry": x}
