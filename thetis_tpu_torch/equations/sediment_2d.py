r"""2D suspended-sediment equation.

Port of ``thetis_tpu/equations/sediment_2d.py`` (the reference's
``thetis/sediment_eq_2d.py``): the tracer advection-diffusion machinery of
:class:`~.tracer_2d.TracerEquation2D` plus

  SedimentErosionTerm     (ref L84-93)   source
  SedimentDepositionTerm  (ref L96-104)  implicit

and the ``equilibrium`` boundary condition (ref L46-55), which sets the
external sediment value to the model's equilibrium concentration of the
boundary's (uv, H) traces.

The advective-velocity correction factor
(``SedimentModel.get_advective_velocity_correction_factor``) reaches the
tracer machinery as its ``tracer_advective_velocity_factor`` field, set
by the model's advance.
"""
import torch

from .tracer_2d import TracerEquation2D

__all__ = ["SedimentEquation2D"]


class SedimentEquation2D(TracerEquation2D):
    def __init__(self, mesh, asm, options, bathymetry, sediment_model,
                 bnd_conditions=None, depth=None, conservative=False):
        self.sediment_model = sediment_model
        super().__init__(mesh, asm, options, bathymetry,
                         labels=["sediment_2d"],
                         bnd_conditions=bnd_conditions, depth=depth)
        self.conservative["sediment_2d"] = bool(conservative)
        self._bnd_ctx = None
        self.add_term("SedimentErosionTerm", "source", self._t_erosion)
        self.add_term("SedimentDepositionTerm", "implicit",
                      self._t_deposition)

    def _H_q(self, c):
        eta_q = self._coeff_q(c["fields"]["elev_2d"])
        bathy_q = self._coeff_q(c["fields"].get("bathymetry_2d",
                                                self.bathymetry))
        return self.depth.total_depth(bathy_q, eta_q)

    def _t_erosion(self, c, B):
        """ref ``sediment_eq_2d.py:84-93``."""
        H_q = self._H_q(c)
        ero = self.sediment_model.get_erosion_term(c["uv_q"], H_q)
        if not self.conservative["sediment_2d"]:
            ero = ero / H_q
        B["sediment_2d_cell"].add(ero)

    def _t_deposition(self, c, B):
        """ref ``sediment_eq_2d.py:96-104``."""
        H_q = self._H_q(c)
        depo = self.sediment_model.get_deposition_coefficient(c["uv_q"],
                                                              H_q)
        B["sediment_2d_cell"].add(-depo / H_q * c["c_q"]["sediment_2d"])

    def _c_ext(self, label, c_b, bnd_values):
        """The tracer's external values plus the ``equilibrium`` BC (ref
        L46-55)."""
        c_ext = super()._c_ext(label, c_b, bnd_values)
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None or "equilibrium" not in keys:
                continue
            if "value" in keys:
                raise ValueError("cannot specify both equilibrium and value "
                                 "for sediment bcs")
            if self._bnd_ctx is None:
                continue
            uv_b, H_b = self._bnd_ctx
            ceq = self.sediment_model.get_equilibrium_tracer(uv_b, H_b)
            if self.conservative["sediment_2d"]:
                ceq = ceq * H_b
            c_ext = torch.where(self._mask_q(self.marker_masks[m]), ceq,
                                c_ext)
        return c_ext

    def build_context(self, solution, solution_old, fields, bnd_values):
        """The tracer context; the boundary's (uv, H) traces are kept for
        the ``equilibrium`` BC (H from the static bed, as the
        reference)."""
        c = super().build_context(solution, solution_old, fields, bnd_values)
        if "uv_tr" in c:
            H_b = self.depth.total_depth(self.bathy_tr0, c["eta_tr0"])
            self._bnd_ctx = (c["uv_tr"][:, 0], H_b)
        return c
