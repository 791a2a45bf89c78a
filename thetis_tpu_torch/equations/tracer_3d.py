r"""3D tracer advection-diffusion on extruded prisms.

Port of ``thetis_tpu/equations/tracer_3d.py`` (conservative form):

  HorizontalAdvectionTerm  upwinded inter-column fluxes, layer by layer
                           over the 2D facet tables
  VerticalAdvectionTerm    upwinded inter-layer fluxes with w (and w_mesh
                           for ALE)
  HorizontalDiffusionTerm  SIPG on vertical facets
  VerticalDiffusionTerm    SIPG on horizontal facets
  SourceTerm

Solution layout ``(nc, 3, nz, 2)``, or ``(nc, 3, nz, 2, k)`` for k
tracers that share the velocity and geometry: the reference ``vmap``s the
scalar residual over a packed component axis, here every term carries
that axis explicitly (a scalar tracer runs as k = 1).  Velocity fields:
uv_3d ``(nc, 3, nz, 2, 2)``, w ``(nc, 3, nz, 2)``.

Open-boundary tracer values are not ported yet (ROADMAP A7): the
equation raises when any boundary condition is given, and every boundary
facet lets the interior value out and nothing in.
"""
import torch

from .base import Bucket, EquationBase

__all__ = ["TracerEquation3D"]


class TracerEquation3D(EquationBase):
    def __init__(self, mesh2d, asm3d, options, bnd_conditions=None,
                 label="salt_3d"):
        if bnd_conditions:
            raise NotImplementedError(
                "3D tracer boundary conditions are not ported to "
                "thetis_tpu_torch yet (ROADMAP A7)")
        super().__init__(mesh2d, asm3d.asm2d, None)
        self.asm3d = asm3d
        self.options = options
        self.label = label
        p = 1
        self.cp = (p + 1) * (p + 2) / 2.0
        self.sipg = float(getattr(options, "sipg_factor_tracer", 1.0))
        self.sipg_v = float(getattr(options, "sipg_factor_vertical_tracer",
                                    1.0))
        self.use_lf = bool(getattr(options, "use_lax_friedrichs_tracer",
                                   False))
        self.add_term("HorizontalAdvectionTerm", "explicit", self._t_hadv)
        self.add_term("VerticalAdvectionTerm", "explicit", self._t_vadv)
        self.add_term("HorizontalDiffusionTerm", "explicit", self._t_hdiff)
        self.add_term("VerticalDiffusionTerm", "explicit", self._t_vdiff)
        self.add_term("SourceTerm", "source", self._t_source)

    # -- context ---------------------------------------------------------
    def build_context(self, cdofs, fields, geom):
        """``cdofs`` (nc, 3, nz, 2, k)."""
        a3 = self.asm3d
        c = {"fields": fields, "geom": geom, "_dofs": cdofs}
        c["c_q"] = a3.cell_values(cdofs)          # (nc,nz,nq,nqv,k)
        uv = fields["uv_3d"]
        c["uv_q"] = a3.cell_values(uv)
        c["c_tr"] = a3.facet_traces(cdofs)        # (nf,2,nz,nqf,nqv,k)
        c["uv_tr"] = a3.facet_traces(uv)          # (nf,2,nz,nqf,nqv,2)
        c["n"] = self.mesh.facet_normal[:, None, None, None, :]
        # interface values for vertical fluxes; ALE: advect with w - w_mesh
        c["c_below"], c["c_above"] = a3.interface_values(cdofs)
        w = fields.get("w_3d")
        if w is not None:
            wm = fields.get("w_mesh_3d")
            w_rel = w if wm is None else w - wm
            c["w_rel"] = w_rel
            wb, wa = a3.interface_values(w_rel)
            c["w_if"] = 0.5 * (wb + wa)
        return c

    # -- terms -----------------------------------------------------------
    def _t_hadv(self, c, B):
        """Conservative horizontal advection with upwinding."""
        n = c["n"]
        B["grad"].add(c["c_q"][..., None] * c["uv_q"][..., None, 0:2])
        un0 = (c["uv_tr"][:, 0] * n).sum(-1)
        un1 = (c["uv_tr"][:, 1] * n).sum(-1)
        un_av = 0.5 * (un0 + un1)
        s = 0.5 * (torch.sign(un_av) + 1.0)[..., None]
        c0, c1 = c["c_tr"][:, 0], c["c_tr"][:, 1]
        c_up = c0 * s + c1 * (1 - s)
        flux = c_up * un_av[..., None]
        mi = self.mask_int.reshape(-1, 1, 1, 1, 1)
        B["vfacet"].add(torch.stack([-flux, flux], dim=1) * mi[:, None])
        if self.use_lf:
            gamma = 0.5 * torch.abs(un_av)[..., None]
            jmp = c1 - c0
            B["vfacet"].add(
                torch.stack([gamma * jmp, -gamma * jmp], dim=1) * mi[:, None])
        # boundary: outflow of the internal value (no inflow value given)
        s0 = 0.5 * (torch.sign(un0) + 1.0)[..., None]
        c_up_b = c0 * s0 + c0 * (1 - s0)
        fl = (c_up_b * un0[..., None]
              * self.mask_bnd.reshape(-1, 1, 1, 1, 1))
        B["vfacet"].add(torch.stack([-fl, torch.zeros_like(fl)], dim=1))

    def _t_vadv(self, c, B):
        """Vertical advection through layer interfaces, upwinded;
        surface and bed closed."""
        if "w_if" not in c:
            return
        w = c["w_if"][..., None]                  # (nc, nz+1, nq, 1)
        cb, ca = c["c_below"], c["c_above"]
        s = 0.5 * (torch.sign(w) + 1.0)
        c_up = cb * s + ca * (1 - s)  # upward flow advects the lower value
        flux = c_up * w
        zero = torch.zeros_like(flux[:, :1])
        flux = torch.cat([zero, flux[:, 1:-1], zero], dim=1)
        # the below side (outward normal +z, along w) gets -flux
        B["hfacet_below"].add(-flux)
        B["hfacet_above"].add(flux)
        # cell term: + c (w - w_mesh) d(test)/dz
        wq = self.asm3d.cell_values(c["w_rel"])
        B["gradz"].add(c["c_q"] * wq[..., None])

    def _t_hdiff(self, c, B):
        mu = c["fields"].get("diffusivity_h")
        if mu is None:
            return
        g = self.asm3d.cell_grads(c["_dofs"], c["geom"])  # (...,k,3)
        B["grad"].add(-mu * g[..., 0:2])
        # SIPG on vertical facets
        sigma = self.sipg * self.cp / self.mesh.facet_l_normal
        sigma_max = torch.maximum(sigma[:, 0], sigma[:, 1]).reshape(
            -1, 1, 1, 1, 1)
        c0, c1 = c["c_tr"][:, 0], c["c_tr"][:, 1]
        pen = sigma_max * mu * (c0 - c1)
        mi = self.mask_int.reshape(-1, 1, 1, 1, 1)
        B["vfacet"].add(torch.stack([-pen, pen], dim=1) * mi[:, None])

    def _t_vdiff(self, c, B):
        mu = c["fields"].get("diffusivity_v")
        if mu is None:
            return
        a3 = self.asm3d
        g = a3.cell_grads(c["_dofs"], c["geom"])
        B["gradz"].add(-mu * g[..., 2])
        # interface penalty: sigma ~ factor/dz
        Dn = c["geom"]["Delta_nodes"]             # (nc, 3, nz)
        D_q = torch.einsum("qd,cdl->clq", a3.asm2d.space.phi, Dn)
        dz_if = 0.5 * (torch.cat([D_q[:, :1], D_q], dim=1)
                       + torch.cat([D_q, D_q[:, -1:]], dim=1))
        sigma = self.sipg_v * 4.0 / torch.clamp_min(dz_if, 1e-12)
        pen = sigma[..., None] * mu * (c["c_below"] - c["c_above"])
        zero = torch.zeros_like(pen[:, :1])
        pen = torch.cat([zero, pen[:, 1:-1], zero], dim=1)
        B["hfacet_below"].add(-pen)
        B["hfacet_above"].add(pen)

    def _t_source(self, c, B):
        """Interior source: a scalar or a (nc, 3, nz, 2) dof field, the
        same for every packed component."""
        src = c["fields"].get(f"source-{self.label}")
        if src is None:
            return
        if isinstance(src, torch.Tensor) and src.dim() == 4:
            src = self.asm3d.cell_values(src)[..., None]
        B["cell"].add(src * torch.ones_like(c["c_q"]))

    # -- assembly --------------------------------------------------------
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values, geom=None):
        """Weak residual of ``solution[self.label]``, (nc, 3, nz, 2) or
        (nc, 3, nz, 2, k)."""
        if geom is None:
            raise ValueError("TracerEquation3D.residual needs geom")
        if bnd_values:
            raise NotImplementedError(
                "3D tracer boundary values are not ported to "
                "thetis_tpu_torch yet (ROADMAP A7)")
        u = solution[self.label]
        packed = u.dim() == 5
        cdofs = u if packed else u[..., None]
        c = self.build_context(cdofs, fields, geom)
        B = {k: Bucket() for k in (
            "cell", "grad", "gradz", "vfacet", "hfacet_below",
            "hfacet_above")}
        for _, method in self.select_terms(label):
            method(c, B)
        a3 = self.asm3d
        r = torch.zeros_like(cdofs)
        if B["cell"]:
            r = r + a3.cell_to_dofs(B["cell"].val, geom)
        if B["grad"] or B["gradz"]:
            gh = (B["grad"].val if B["grad"]
                  else c["c_q"].new_zeros(c["c_q"].shape + (2,)))
            gz = B["gradz"].val if B["gradz"] else torch.zeros_like(c["c_q"])
            r = r + a3.grad_to_dofs(torch.cat([gh, gz[..., None]], dim=-1),
                                    geom)
        if B["vfacet"]:
            r = r + a3.vfacet_to_dofs(B["vfacet"].val, geom)
        if B["hfacet_below"] or B["hfacet_above"]:
            zb = torch.zeros_like(c["c_below"])
            r = r + a3.hfacet_to_dofs(
                B["hfacet_below"].val if B["hfacet_below"] else zb,
                B["hfacet_above"].val if B["hfacet_above"] else zb, geom)
        return {self.label: r if packed else r[..., 0]}

    def mass_term(self, solution, geom):
        return {self.label: self.asm3d.mass_apply(solution[self.label], geom)}

    def mass_inverse(self, r, geom):
        return {self.label: self.asm3d.mass_inverse(r[self.label], geom)}
