r"""RT2 x P1DG shallow-water pair, the reference's DEFAULT ``rt-dg`` member
(port of ``thetis_tpu/equations/shallowwater_rt2.py``;
``polynomial_degree = 1``: ref ``solver2d.py:329-336`` builds ``RT(p+1) x
P(p)DG``; with :class:`~thetis_tpu_torch.fem.bdm2.BDM2Space` the
``bdm-dg`` BDM2 x P1DG).

Weak forms specialise the reference terms (``shallowwater_eq.py``) to a
conforming H(div) velocity and a DG-1 elevation:

* ExternalPressureGradientTerm (ref L335-381): by parts, ``+g eta
  div(psi)`` at cell quadrature points; interior facet terms vanish
  because ``jump(psi . n) = 0``; boundaries carry the linear-Riemann
  elevation.
* HUDivTerm (ref L396-450): the conservative facet flux ``F* = H (u.n +
  1/2 sqrt(g/H) jump(eta))`` against the DG-1 elevation test.
* HorizontalAdvectionTerm (ref L453-510): conservative form, ``(u x u) :
  grad(psi)`` in cells with upwinded interface momentum flux.
* Coriolis / drag / sources: cell quadrature integrals against psi.

Solution dict: ``{'uv': (ndofs,), 'elev': (nc, 3)}``.  The paired
:class:`~thetis_tpu_torch.fem.assembly.DGAssembler` must use
``quad_degree >= 4`` (5 for BDM2).
"""
import torch

from ..config import physical_constants
from ..fem.assembly import coefficient_cell_q
from .base import Bucket, EquationBase, facet_quad_value

__all__ = ["ShallowWaterEquationsRT2DG"]


def _data(val):
    return val.data if hasattr(val, "function_space") else val


class ShallowWaterEquationsRT2DG(EquationBase):
    def __init__(self, mesh, asm, rt_space, options, bathymetry,
                 bnd_conditions=None):
        if getattr(options, "use_wetting_and_drying", False):
            raise ValueError(
                "wetting-and-drying requires the dg-dg element family")
        super().__init__(mesh, asm, bnd_conditions)
        self.rt = rt_space
        self.options = options
        self.g = float(physical_constants["g_grav"])
        self.bathy_q = coefficient_cell_q(asm, _data(bathymetry))
        self.bathy_tr0 = facet_quad_value(asm, _data(bathymetry))

        self.add_term("ExternalPressureGradientTerm", "implicit",
                      self._t_epg)
        self.add_term("HUDivTerm", "implicit", self._t_hudiv)
        self.add_term("HorizontalAdvectionTerm", "implicit", self._t_hadv)
        self.add_term("CoriolisTerm", "implicit", self._t_coriolis)
        self.add_term("QuadraticDragTerm", "implicit", self._t_qdrag)
        self.add_term("LinearDragTerm", "implicit", self._t_ldrag)
        self.add_term("MomentumSourceTerm", "source", self._t_mom_source)
        self.add_term("ContinuitySourceTerm", "source", self._t_cont_source)

    def _cell_q(self, val, vector=False):
        return coefficient_cell_q(self.asm, _data(val), vector=vector)

    # ------------------------------------------------------------------
    def _bnd_ext(self, eta_b, un_b, bnd_values):
        """External (eta_ext, un_ext) at boundary-facet quad points
        (ref ``shallowwater_eq.py:232-272``)."""
        asm = self.asm
        eta_ext, un_ext = eta_b, un_b
        nf_n = self.mesh.facet_normal[:, None, :]
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            vals = bnd_values[m]
            mask = self._mask_q(self.marker_masks[m])
            e_m = (facet_quad_value(asm, vals["elev"])
                   if "elev" in keys else eta_b)
            if "un" in keys:
                u_m = facet_quad_value(asm, vals["un"])
            elif "uv" in keys:
                v = facet_quad_value(asm, vals["uv"], vector=True)
                u_m = (v * nf_n).sum(-1)
            elif "flux" in keys:
                H = torch.clamp_min(self.bathy_tr0 + e_m, 0.05)
                area = H * self.mesh.boundary_len.get(m, 1.0)
                u_m = facet_quad_value(asm, vals["flux"]) / area
            else:
                u_m = un_b
            eta_ext = torch.where(mask, e_m, eta_ext)
            un_ext = torch.where(mask, u_m, un_ext)
        return eta_ext, un_ext

    # ------------------------------------------------------------------
    def build_context(self, solution, solution_old, fields, bnd_values):
        rt, asm = self.rt, self.asm
        U, eta = solution["uv"], solution["elev"]
        eta_old = solution_old["elev"]
        c = {"fields": fields, "U": U, "eta": eta}
        c["uv_q"] = rt.cell_values(U)                  # (nc, nq, 2)
        c["eta_q"] = asm.cell_values(eta)              # (nc, nq)
        c["eta_tr"] = asm.facet_traces(eta)            # (nf, 2, nqf)
        c["un_q"] = rt.facet_un_quad(U)                # (nf, nqf)
        nonlin = getattr(self.options, "use_nonlinear_equations", True)
        H_c = self.bathy_q + (asm.cell_values(eta_old) if nonlin else 0.0)
        c["H_q"] = torch.clamp_min(H_c, 0.05)
        eta_old_tr = asm.facet_traces(eta_old)
        H_f = self.bathy_tr0 + (
            0.5 * (eta_old_tr[:, 0] + eta_old_tr[:, 1]) if nonlin else 0.0)
        c["H_f"] = torch.clamp_min(H_f, 0.05)          # (nf, nqf)
        c["eta_ext"], c["un_ext"] = self._bnd_ext(
            c["eta_tr"][:, 0], c["un_q"], bnd_values)
        return c

    # ============================ terms ================================
    def _t_epg(self, c, B):
        g = self.g
        B["uv"] = B.get("uv", 0.0) + self.rt.div_to_dofs(g * c["eta_q"])
        # boundary: -g eta_rie psi.n (interior facet terms vanish by
        # H(div) conformity)
        srt = torch.sqrt(c["H_f"] / g)
        eta_b = c["eta_tr"][:, 0]
        un = c["un_q"]
        eta_rie_open = (0.5 * (eta_b + c["eta_ext"])
                        + srt * 0.5 * (un - c["un_ext"]))
        eta_rie_land = eta_b + srt * un
        mo = self._mask_q(self.mask_open)
        mb = self._mask_q(self.mask_bnd)
        eta_rie = torch.where(mo, eta_rie_open, eta_rie_land)
        B["uv"] = B["uv"] - self.rt.bnd_normal_to_dofs(g * eta_rie * mb)

    def _t_hudiv(self, c, B):
        g = self.g
        un, H_f = c["un_q"], c["H_f"]
        srt = torch.sqrt(g / H_f)
        e0, e1 = c["eta_tr"][:, 0], c["eta_tr"][:, 1]
        F_int = H_f * (un + 0.5 * srt * (e0 - e1))
        un_rie = 0.5 * (un + c["un_ext"]) + 0.5 * srt * (e0 - c["eta_ext"])
        F_bnd = torch.where(self._mask_q(self.mask_open), H_f * un_rie,
                            torch.zeros_like(un_rie))
        mi = self._mask_q(self.mask_int)
        mb = self._mask_q(self.mask_bnd)
        # cell: +H u . grad(phi)
        B["elev_grad"].add(c["H_q"][..., None] * c["uv_q"])
        # interior + boundary facet flux against the DG test traces
        Fi = F_int * mi
        Fb = F_bnd * mb
        B["elev_facet"].add(torch.stack([-(Fi + Fb), Fi], dim=1))

    def _t_hadv(self, c, B):
        if not getattr(self.options, "use_nonlinear_equations", True):
            return
        rt = self.rt
        uv_q = c["uv_q"]
        G = uv_q[..., :, None] * uv_q[..., None, :]    # u_i u_j
        B["uv"] = B.get("uv", 0.0) + rt.grad_to_dofs(G)
        tr = rt.facet_traces(c["U"])                   # (nf, 2, nqf, 2)
        un = c["un_q"]
        s = 0.5 * (torch.sign(un) + 1.0)
        u_up = tr[:, 0] * s[..., None] + tr[:, 1] * (1.0 - s)[..., None]
        flux = u_up * un[..., None]
        mi = self._mask_q(self.mask_int)[..., None]
        Ff = torch.stack([-flux, flux], dim=1) * mi[:, None]
        # open-boundary closure with the side-0 trace (ref L213-246)
        flux_b = tr[:, 0] * un[..., None]
        mb = self._mask_q(self.mask_bnd)[..., None]
        Ff = Ff + torch.stack([-flux_b, torch.zeros_like(flux_b)],
                              dim=1) * mb[:, None]
        B["uv"] = B["uv"] + rt.facet_to_dofs(Ff)

    def _t_coriolis(self, c, B):
        f = c["fields"].get("coriolis")
        if f is None:
            return
        f_q = self._cell_q(f)
        u = c["uv_q"]
        Fq = torch.stack([f_q * u[..., 1], -f_q * u[..., 0]], dim=-1)
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(Fq)

    def _t_qdrag(self, c, B):
        fields = c["fields"]
        Cd = fields.get("quadratic_drag_coefficient")
        mu = fields.get("manning_drag_coefficient")
        if Cd is None and mu is None:
            return
        H_q = c["H_q"]
        if mu is not None:
            Cd_q = self.g * self._cell_q(mu) ** 2 / H_q ** (1.0 / 3.0)
        else:
            Cd_q = self._cell_q(Cd)
        u = c["uv_q"]
        umag = torch.sqrt((u**2).sum(-1) + 1e-12)
        Fq = -(Cd_q * umag / H_q)[..., None] * u
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(Fq)

    def _t_ldrag(self, c, B):
        C = c["fields"].get("linear_drag_coefficient")
        if C is None:
            return
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(
            -self._cell_q(C)[..., None] * c["uv_q"])

    def _t_mom_source(self, c, B):
        src = c["fields"].get("momentum_source")
        if src is None:
            return
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(
            self._cell_q(src, vector=True))

    def _t_cont_source(self, c, B):
        src = c["fields"].get("volume_source")
        if src is None:
            return
        B["elev_cell"].add(self._cell_q(src))

    # =========================== assembly ==============================
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        asm = self.asm
        c = self.build_context(solution, solution_old, fields, bnd_values)
        B = {"elev_cell": Bucket(), "elev_grad": Bucket(),
             "elev_facet": Bucket()}
        for _, method in self.select_terms(label):
            method(c, B)
        r_uv = B.get("uv")
        if r_uv is None or isinstance(r_uv, float):
            r_uv = torch.zeros_like(solution["uv"])
        r_e = torch.zeros_like(solution["elev"])
        if B["elev_cell"]:
            r_e = r_e + asm.cell_to_dofs(B["elev_cell"].val)
        if B["elev_grad"]:
            r_e = r_e + asm.grad_to_dofs(B["elev_grad"].val)
        if B["elev_facet"]:
            r_e = r_e + asm.facet_to_dofs(B["elev_facet"].val)
        return {"uv": r_uv, "elev": r_e}

    def mass_term(self, solution):
        return {"uv": self.rt.mass_apply(solution["uv"]),
                "elev": self.asm.mass_apply(solution["elev"])}

    def mass_inverse(self, r):
        return {"uv": self.mass_inverse_uv(r["uv"]),
                "elev": self.mass_inverse_elev(r["elev"])}

    def mass_inverse_uv(self, r_uv):
        return self.rt.mass_inverse(r_uv)

    def mass_inverse_elev(self, r_elev):
        return self.asm.mass_inverse(r_elev)

    def norm_elev(self, eta):
        return self.asm.norm_l2(eta)

    def norm_uv(self, U):
        return torch.sqrt(torch.clamp_min(
            (U * self.rt.mass_apply(U)).sum(), 0.0))
