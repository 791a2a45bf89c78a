r"""Depth-averaged 2D shallow water equations (nonconservative form).

Port of ``thetis_tpu/equations/shallowwater_2d.py`` (the reference term
set of ``thetis/shallowwater_eq.py``):

momentum (d uv/dt = ...):
  ExternalPressureGradientTerm   (ref L335-393)   implicit
  HorizontalAdvectionTerm        (ref L453-510)   implicit
  HorizontalViscosityTerm        (ref L513-616)   explicit
  CoriolisTerm                   (ref L619-634)   implicit
  WindStressTerm                 (ref L637-649)   source
  AtmosphericPressureTerm        (ref L652-663)   source
  QuadraticDragTerm              (ref L666-701)   implicit
  LinearDragTerm                 (ref L728-740)   implicit
  BoundaryDragTerm               (ref L704-725)   implicit
  TurbineDragTerm                (ref L765-791)   implicit
  MomentumSourceTerm             (ref L794-811)   source
continuity (d eta/dt = ...):
  HUDivTerm                      (ref L396-450)   implicit
  ContinuitySourceTerm           (ref L814-831)   source

:class:`ModeSplit2DEquations` is the reduced barotropic system of the 3D
mode-split step.  With ``use_wetting_and_drying`` the total depth gains
the bathymetry displacement of Karna et al. (2011), with alpha a scalar
or a P1 field, and the continuity row's mass term the displaced
volume (ref L834-850); ``mass_inverse`` stays the exact DG block
inverse, which is then only a preconditioner.  A bed evolved by the
Exner equation reaches every term through ``fields["bathymetry_2d"]``
(the static tabulations otherwise); the tidal turbine farms of
``model/turbines.py`` add their drag.

Every term is functional (out-of-place updates, no host reads, no
branching on tensor values), so the value-space block assembly
(``equations/swe_blocks.py``) can linearize it with ``torch.func``.

Solution dict: ``{'uv': (nc, nd, 2), 'elev': (nc, nd)}``.
"""
import numpy as np
import torch

from ..config import physical_constants
from ..fem.assembly import coefficient_cell_q
from .base import Bucket, EquationBase, facet_quad_value, facet_quad_value_2s

__all__ = ["ShallowWaterEquations", "ModeSplit2DEquations",
           "DepthExpression", "swe_state"]


def swe_state(uv, elev):
    return {"uv": uv, "elev": elev}


def _safe_mag(sq):
    """sqrt of a non-negative quantity with a derivative-safe floor (sqrt
    at exactly 0 has an infinite derivative)."""
    return torch.sqrt(torch.clamp_min(sq, 1e-28))


class DepthExpression:
    """Total-depth expression incl. the wetting-and-drying displacement
    (ref ``thetis/utility.py:936-995``, Karna et al. 2011).

    ``alpha`` may be a scalar or a tensor evaluated at the same points as
    ``bathy``/``eta`` (the spatially varying automatic alpha); when
    omitted the default scalar is used."""

    def __init__(self, use_nonlinear_equations=True,
                 use_wetting_and_drying=False, wetting_and_drying_alpha=0.5):
        self.use_nonlinear_equations = use_nonlinear_equations
        self.use_wetting_and_drying = use_wetting_and_drying
        self.alpha = wetting_and_drying_alpha

    def wd_displacement(self, bathy, eta, alpha=None):
        if not self.use_wetting_and_drying:
            return torch.zeros_like(eta)
        a = self.alpha if alpha is None else alpha
        h = bathy + eta
        return 0.5 * (torch.sqrt(h**2 + a**2) - h)

    def total_depth(self, bathy, eta, alpha=None):
        if not self.use_nonlinear_equations:
            return bathy * torch.ones_like(eta)
        return bathy + eta + self.wd_displacement(bathy, eta, alpha)


def _is_scalar(a):
    return np.isscalar(a) or getattr(a, "ndim", 1) == 0


class ShallowWaterEquations(EquationBase):
    def __init__(self, mesh, asm, options, bathymetry, bnd_conditions=None,
                 tidal_farms=None):
        """
        :arg asm: DGAssembler for the (shared) P1DG space
        :arg options: ModelOptions2d-like namespace
        :arg bathymetry: dof array: CG1 (nv,), DG (nc, nd) or scalar
        :arg bnd_conditions: {marker: {'elev'/'uv'/'un'/'flux'/'drag': value}}
        :arg tidal_farms: list of :class:`~..model.turbines.TidalTurbineFarm`
        """
        super().__init__(mesh, asm, bnd_conditions)
        self.options = options
        self.tidal_farms = tidal_farms or []
        a0 = getattr(options, "wetting_and_drying_alpha", 0.5)
        self.depth = DepthExpression(
            use_nonlinear_equations=options.use_nonlinear_equations,
            use_wetting_and_drying=getattr(options, "use_wetting_and_drying",
                                           False),
            wetting_and_drying_alpha=float(a0) if _is_scalar(a0) else 0.5)
        self.g = physical_constants["g_grav"]
        self.rho0 = physical_constants["rho0"]

        self.set_bathymetry(bathymetry)

        # SIPG penalty: sigma = factor * cp / l_normal  (ref L573-587)
        p = asm.space.degree
        self.cp = (p + 1) * (p + 2) / 2.0

        self.add_term("ExternalPressureGradientTerm", "implicit", self._t_epg)
        self.add_term("HorizontalAdvectionTerm", "implicit", self._t_hadv)
        self.add_term("HorizontalViscosityTerm", "explicit", self._t_hvisc)
        self.add_term("CoriolisTerm", "implicit", self._t_coriolis)
        self.add_term("WindStressTerm", "source", self._t_wind)
        self.add_term("AtmosphericPressureTerm", "source", self._t_atm)
        self.add_term("QuadraticDragTerm", "implicit", self._t_qdrag)
        self.add_term("LinearDragTerm", "implicit", self._t_ldrag)
        self.add_term("BoundaryDragTerm", "implicit", self._t_bdrag)
        if self.tidal_farms:
            self.add_term("TurbineDragTerm", "implicit", self._t_turbine)
        self.add_term("MomentumSourceTerm", "source", self._t_mom_source)
        self.add_term("HUDivTerm", "implicit", self._t_hudiv)
        self.add_term("ContinuitySourceTerm", "source", self._t_cont_source)

    # ------------------------------------------------------------------
    def set_bathymetry(self, bathymetry):
        asm = self.asm
        self.bathymetry = bathymetry
        self.bathy_q = self._any_cell_q(bathymetry)
        self.bathy_grad_q = self._any_cell_grad(bathymetry)
        # both-side traces (nf, 2, nqf); identical sides unless bathymetry is DG
        self.bathy_tr = facet_quad_value_2s(asm, bathymetry)
        # wetting-and-drying alpha at the same sites (may be a P1 field)
        a = getattr(self.options, "wetting_and_drying_alpha", 0.5)
        if hasattr(a, "data"):
            a = a.data
        if _is_scalar(a):
            self.alpha_q = self.alpha_tr = float(a)
        else:
            self.alpha_q = self._any_cell_q(a)
            self.alpha_tr = facet_quad_value_2s(asm, a)

    def _alpha_tr0(self):
        a = self.alpha_tr
        return a if isinstance(a, float) else a[:, 0]

    def _any_cell_q(self, val, vector=False):
        return coefficient_cell_q(self.asm, val, vector=vector)

    def _any_cell_grad(self, val, vector=False):
        asm, mesh = self.asm, self.mesh
        nq = len(asm.space._tab_np["qw"])
        tail = (2,) if vector else ()
        if val is None:
            return None
        if np.isscalar(val) or (hasattr(val, "ndim") and val.ndim == len(tail)):
            return torch.zeros((mesh.nc, nq) + tail + (2,), dtype=mesh.dtype,
                               device=mesh.device)
        val = asm.as_tensor(val)
        if val.shape[:1] == (mesh.nv,):
            return asm.cg1_grads(val[mesh.cells])
        if val.shape[:2] == (mesh.nc, asm.ndofs):
            return asm.cell_grads(val)
        if val.shape[:2] == (mesh.nc, 1):
            return torch.zeros((mesh.nc, nq) + tail + (2,), dtype=mesh.dtype,
                               device=mesh.device)
        raise ValueError(
            f"cannot differentiate coefficient of shape {tuple(val.shape)}")

    # ------------------------------------------------------------------
    def _bnd_ext(self, eta_b, uv_b, bnd_values, bathy_tr0=None):
        """External (eta_ext, uv_ext) at boundary-facet quad points given
        in-values (eta_b, uv_b), per ref ``shallowwater_eq.py:232-272``.

        Returns full (nf, nqf[,2]) tensors; only open-boundary entries are
        meaningful."""
        asm = self.asm
        eta_ext = eta_b
        uv_ext = uv_b
        nf_n = self.mesh.facet_normal[:, None, :]  # (nf,1,2)
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            vals = bnd_values[m]
            mask = self._mask_q(self.marker_masks[m])
            if "elev" in keys:
                e_m = facet_quad_value(asm, vals["elev"])
            else:
                e_m = eta_b
            if "uv" in keys:
                u_m = facet_quad_value(asm, vals["uv"], vector=True)
            elif "un" in keys:
                u_m = facet_quad_value(asm, vals["un"])[..., None] * nf_n
            elif "flux" in keys:
                # 'flux': area from external elevation if given, else the
                # internal one (ref L249-253 vs L263-267)
                b0 = self.bathy_tr[:, 0] if bathy_tr0 is None else bathy_tr0
                h_ext = self.depth.total_depth(b0, e_m, self._alpha_tr0())
                area = h_ext * self.mesh.boundary_len.get(m, 1.0)
                u_m = (facet_quad_value(asm, vals["flux"])
                       / area)[..., None] * nf_n
            else:
                u_m = uv_b
            eta_ext = torch.where(mask, e_m, eta_ext)
            uv_ext = torch.where(self._mask_q(self.marker_masks[m], 1), u_m,
                                 uv_ext)
        return eta_ext, uv_ext

    # ------------------------------------------------------------------
    def build_context(self, solution, solution_old, fields, bnd_values):
        """Evaluate all shared quad-point quantities once per residual call."""
        asm = self.asm
        uv, eta = solution["uv"], solution["elev"]
        uv_old, eta_old = solution_old["uv"], solution_old["elev"]
        # morphodynamics: an Exner-evolved bed comes through the fields
        # (ref L222-234); the static tabulations otherwise
        bdyn = fields.get("bathymetry_2d")
        if bdyn is not None:
            c = {"bathy_q": self._any_cell_q(bdyn),
                 "bathy_grad_q": self._any_cell_grad(bdyn),
                 "bathy_tr": facet_quad_value_2s(asm, bdyn)}
        else:
            c = {"bathy_q": self.bathy_q, "bathy_grad_q": self.bathy_grad_q,
                 "bathy_tr": self.bathy_tr}
        # one packed evaluation of current and lagged fields
        packed = torch.cat(
            [uv, eta[..., None], uv_old, eta_old[..., None]], dim=-1
        )  # (nc, nd, 6)
        pq = asm.cell_values(packed)  # (nc, nq, 6)
        c["uv_q"] = pq[..., 0:2]
        c["eta_q"] = pq[..., 2]
        c["uv_old_q"] = pq[..., 3:5]
        c["eta_old_q"] = pq[..., 5]
        c["H_q"] = self.depth.total_depth(c["bathy_q"], c["eta_old_q"],
                                          self.alpha_q)
        ptr = asm.facet_traces(packed)  # (nf, 2, nqf, 6)
        c["uv_tr"] = ptr[..., 0:2]
        c["eta_tr"] = ptr[..., 2]
        c["uv_old_tr"] = ptr[..., 3:5]
        c["eta_old_tr"] = ptr[..., 5]
        c["H_tr"] = self.depth.total_depth(c["bathy_tr"], c["eta_old_tr"],
                                           self.alpha_tr)
        c["n"] = self.mesh.facet_normal[:, None, :]  # (nf,1,2)

        # boundary externals (current and old linearisation states)
        c["eta_ext"], c["uv_ext"] = self._bnd_ext(
            c["eta_tr"][:, 0], c["uv_tr"][:, 0], bnd_values,
            c["bathy_tr"][:, 0])
        c["eta_ext_old"], c["uv_ext_old"] = self._bnd_ext(
            c["eta_old_tr"][:, 0], c["uv_old_tr"][:, 0], bnd_values,
            c["bathy_tr"][:, 0])
        c["fields"] = fields
        c["bnd_values"] = bnd_values
        return c

    # =========================== terms =================================
    # each term: method(ctx, buckets) with buckets B = dict of Bucket
    def _t_epg(self, c, B):
        """g grad(eta); DG by-parts with Riemann elevation (ref L335-393)."""
        g = self.g
        n = c["n"]
        # cell: + g eta * div(test)
        eye = torch.eye(2, dtype=n.dtype, device=n.device)
        B["uv_grad"].add(g * c["eta_q"][..., None, None] * eye)
        # interior: head_star = avg(eta) + sqrt(avg(H)/g) jump(uv, n)
        eta0, eta1 = c["eta_tr"][:, 0], c["eta_tr"][:, 1]
        uv0, uv1 = c["uv_tr"][:, 0], c["uv_tr"][:, 1]
        h_avg = 0.5 * (c["H_tr"][:, 0] + c["H_tr"][:, 1])
        jump_un = ((uv0 - uv1) * n).sum(-1)
        head_star = (0.5 * (eta0 + eta1)
                     + torch.sqrt(torch.abs(h_avg) / g) * jump_un)
        mi = self._mask_q(self.mask_int, 1)
        B["uv_facet"].add(
            torch.stack(
                [-g * head_star[..., None] * n, g * head_star[..., None] * n],
                dim=1,
            )
            * mi[:, None]
        )
        # boundary
        eta_b, uv_b, H_b = c["eta_tr"][:, 0], c["uv_tr"][:, 0], c["H_tr"][:, 0]
        un_b = (uv_b * n).sum(-1)
        srt = torch.sqrt(torch.abs(H_b) / g)
        # open: linear Riemann (ref L372-375)
        un_jump = ((uv_b - c["uv_ext"]) * n).sum(-1)
        eta_rie_open = 0.5 * (eta_b + c["eta_ext"]) + srt * un_jump
        # land: impermeability => external un = 0 (ref L377-381)
        eta_rie_land = eta_b + srt * un_b
        eta_rie = torch.where(self._mask_q(self.mask_open), eta_rie_open,
                              eta_rie_land)
        contrib = -g * eta_rie[..., None] * n * self._mask_q(self.mask_bnd, 1)
        B["uv_facet"].add(
            torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def _t_hudiv(self, c, B):
        """div(H uv) in the continuity eq (ref L396-450)."""
        g = self.g
        n = c["n"]
        # cell: + H uv . grad(test)
        B["eta_grad"].add(c["H_q"][..., None] * c["uv_q"])
        # interior Riemann flux (ref L424-427)
        uv0, uv1 = c["uv_tr"][:, 0], c["uv_tr"][:, 1]
        eta0, eta1 = c["eta_tr"][:, 0], c["eta_tr"][:, 1]
        h = 0.5 * (c["H_tr"][:, 0] + c["H_tr"][:, 1])
        uv_rie = 0.5 * (uv0 + uv1) + (
            torch.sqrt(g / torch.abs(h)) * (eta0 - eta1)
        )[..., None] * n
        hu_star_n = h * (uv_rie * n).sum(-1)
        mi = self._mask_q(self.mask_int)
        B["eta_facet"].add(
            torch.stack([-hu_star_n, hu_star_n], dim=1) * mi[:, None])
        # open boundary (ref L431-442); closed: no flux
        eta_b, uv_b = c["eta_tr"][:, 0], c["uv_tr"][:, 0]
        eta_old_b, uv_old_b = c["eta_old_tr"][:, 0], c["uv_old_tr"][:, 0]
        H_b = c["H_tr"][:, 0]
        H_ext_old = self.depth.total_depth(
            c["bathy_tr"][:, 0], c["eta_ext_old"], self._alpha_tr0())
        h_av = 0.5 * (H_b + H_ext_old)
        h_av_safe = torch.clamp_min(torch.abs(h_av), 1e-12)
        un_rie = 0.5 * ((uv_b + c["uv_ext"]) * n).sum(-1) + torch.sqrt(
            g / h_av_safe) * (eta_b - c["eta_ext"])
        un_jump_old = ((uv_old_b - c["uv_ext_old"]) * n).sum(-1)
        eta_rie = 0.5 * (eta_old_b + c["eta_ext_old"]) + torch.sqrt(
            h_av_safe / g) * un_jump_old
        h_rie = self.depth.total_depth(c["bathy_tr"][:, 0], eta_rie,
                                       self._alpha_tr0())
        contrib = -h_rie * un_rie * self._mask_q(self.mask_open)
        B["eta_facet"].add(
            torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def _t_hadv(self, c, B):
        """Momentum advection with upwinded mean flux + Lax-Friedrichs
        stabilisation (ref L453-510)."""
        if not self.options.use_nonlinear_equations:
            return
        asm = self.asm
        n = c["n"]
        uv_old_grad = asm.cell_grads(c.get("_uv_old_dofs"))
        div_uv_old = uv_old_grad[..., 0, 0] + uv_old_grad[..., 1, 1]
        B["uv_cell"].add(div_uv_old[..., None] * c["uv_q"])
        B["uv_grad"].add(c["uv_q"][..., :, None] * c["uv_old_q"][..., None, :])
        # interior: mean flux upwinding
        uv0, uv1 = c["uv_tr"][:, 0], c["uv_tr"][:, 1]
        uvo0, uvo1 = c["uv_old_tr"][:, 0], c["uv_old_tr"][:, 1]
        uv_avg = 0.5 * (uv0 + uv1)
        un0 = (uvo0 * n).sum(-1)
        un1 = (uvo1 * n).sum(-1)
        mi = self._mask_q(self.mask_int, 1)
        B["uv_facet"].add(
            torch.stack(
                [-uv_avg * un0[..., None], uv_avg * un1[..., None]], dim=1
            )
            * mi[:, None]
        )
        if self.options.use_lax_friedrichs_velocity:
            lf = c["fields"].get("lax_friedrichs_velocity_scaling_factor", 1.0)
            un_av = 0.5 * (un0 + un1)
            gamma = 0.5 * torch.abs(un_av) * lf
            jmp = uv1 - uv0
            B["uv_facet"].add(
                torch.stack([gamma[..., None] * jmp, -gamma[..., None] * jmp],
                            dim=1)
                * mi[:, None]
            )
            # land boundary: mirror-velocity LF penalty (ref L492-497)
            uv_b = c["uv_tr"][:, 0]
            un_b = (uv_b * n).sum(-1)
            un_old_b = (c["uv_old_tr"][:, 0] * n).sum(-1)
            gamma_b = 0.5 * torch.abs(un_old_b) * lf
            contrib = (
                -gamma_b[..., None] * 2.0 * un_b[..., None] * n
            ) * self._mask_q(self.mask_land, 1)
            B["uv_facet"].add(
                torch.stack([contrib, torch.zeros_like(contrib)], dim=1))
        # open boundary: Riemann normal velocity (ref L498-509)
        eta_old_b = c["eta_old_tr"][:, 0]
        uv_old_b = c["uv_old_tr"][:, 0]
        H_b = c["H_tr"][:, 0]
        un_rie = 0.5 * ((uv_old_b + c["uv_ext_old"]) * n).sum(-1) + torch.sqrt(
            self.g / torch.clamp_min(torch.abs(H_b), 1e-12)
        ) * (eta_old_b - c["eta_ext_old"])
        uv_av = 0.5 * (c["uv_ext"] + c["uv_tr"][:, 0])
        contrib = -un_rie[..., None] * uv_av * self._mask_q(self.mask_open, 1)
        B["uv_facet"].add(
            torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def _t_hvisc(self, c, B):
        """SIPG viscosity, optional grad-div / grad-depth forms
        (ref L513-616)."""
        nu_f = c["fields"].get("viscosity_h")
        if nu_f is None:
            return
        asm = self.asm
        n = c["n"]
        nu_q = self._any_cell_q(nu_f)
        nu_tr = facet_quad_value_2s(asm, nu_f)
        # (nc,nq,2,2): [k,i]=du_k/dx_i; the block assembler injects
        # value-space tangents here
        uv_grad = c.get("uv_grad_q")
        if uv_grad is None:
            uv_grad = asm.cell_grads(c["_uv_dofs"])
        if self.options.use_grad_div_viscosity_term:
            sym = uv_grad + torch.swapaxes(uv_grad, -1, -2)
            stress = nu_q[..., None, None] * sym
        else:
            stress = nu_q[..., None, None] * uv_grad
        B["uv_grad"].add(-stress)

        # SIPG penalty sigma = factor*cp/l_normal, max over sides (L573-587)
        sipg = float(self.options.sipg_factor)
        ln = self.mesh.facet_l_normal  # (nf,2)
        sigma = sipg * self.cp / ln
        sigma_max = torch.maximum(sigma[:, 0], sigma[:, 1])[:, None, None]

        uv0, uv1 = c["uv_tr"][:, 0], c["uv_tr"][:, 1]
        nu_avg = 0.5 * (nu_tr[:, 0] + nu_tr[:, 1])
        djump = uv0 - uv1  # tensor_jump = outer(djump, nf)
        if self.options.use_grad_div_viscosity_term:
            SJ = nu_avg[..., None, None] * (
                djump[..., :, None] * n[..., None, :]
                + n[..., :, None] * djump[..., None, :]
            )
        else:
            SJ = nu_avg[..., None, None] * djump[..., :, None] * n[..., None, :]
        SJn = (SJ * n[..., None, :]).sum(-1)  # SJ . n
        mi1 = self._mask_q(self.mask_int, 1)
        mi2 = self._mask_q(self.mask_int, 2)
        # penalty term
        B["uv_facet"].add(
            torch.stack([-sigma_max * SJn, sigma_max * SJn], dim=1)
            * mi1[:, None])
        # - inner(avg(grad(test)), SJ)
        B["uv_fgrad"].add(
            torch.stack([0.5 * SJ, 0.5 * SJ], dim=1) * mi2[:, None])
        # - inner(tensor_jump(test,n), avg(stress))
        grads_tr = c.get("uv_grad_tr")  # (nf,2,nqf,2,2)
        if grads_tr is None:
            grads_tr = asm.facet_trace_grads(c["_uv_dofs"])
        if self.options.use_grad_div_viscosity_term:
            grads_tr = grads_tr + torch.swapaxes(grads_tr, -1, -2)
        stress_tr = nu_tr[..., None, None] * grads_tr
        avg_stress_n = (0.5 * (stress_tr[:, 0] + stress_tr[:, 1])
                        * n[..., None, :]).sum(-1)
        B["uv_facet"].add(
            torch.stack([avg_stress_n, -avg_stress_n], dim=1) * mi1[:, None])

        # Dirichlet boundary terms (only when external data prescribes uv)
        uv_b = c["uv_tr"][:, 0]
        stress_b = stress_tr[:, 0]
        nu_b = nu_tr[:, 0]
        sigma_b = sigma[:, 0][:, None, None]
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            if "un" in keys:
                un_val = facet_quad_value(asm, c["bnd_values"][m]["un"])
                delta_uv = ((uv_b * n).sum(-1) - un_val)[..., None] * n
            elif "uv" in keys or "flux" in keys:
                delta_uv = uv_b - c["uv_ext"]
            else:
                continue  # only 'elev': uv_ext is uv -> no-op (ref L598-599)
            mk1 = self._mask_q(self.marker_masks[m], 1)
            mk2 = self._mask_q(self.marker_masks[m], 2)
            if self.options.use_grad_div_viscosity_term:
                SJb = nu_b[..., None, None] * (
                    delta_uv[..., :, None] * n[..., None, :]
                    + n[..., :, None] * delta_uv[..., None, :]
                )
            else:
                SJb = (nu_b[..., None, None] * delta_uv[..., :, None]
                       * n[..., None, :])
            SJbn = (SJb * n[..., None, :]).sum(-1)
            stress_bn = (stress_b * n[..., None, :]).sum(-1)
            contrib = (-sigma_b * SJbn + stress_bn) * mk1
            B["uv_facet"].add(
                torch.stack([contrib, torch.zeros_like(contrib)], dim=1))
            B["uv_fgrad"].add(
                torch.stack([SJb * mk2, torch.zeros_like(SJb)], dim=1))

        if self.options.use_grad_depth_viscosity_term:
            grad_eta_old = c.get("eta_old_grad_q")
            if grad_eta_old is None:
                grad_eta_old = asm.cell_grads(c["_eta_old_dofs"])
            grad_H = c["bathy_grad_q"] + grad_eta_old
            # + test . (grad(H)/H . stress)  (ref L613-614)
            B["uv_cell"].add(
                (grad_H[..., :, None] * stress).sum(-2) / c["H_q"][..., None])

    def _t_coriolis(self, c, B):
        cor = c["fields"].get("coriolis")
        if cor is None:
            return
        f_q = self._any_cell_q(cor)
        uv = c["uv_q"]
        B["uv_cell"].add(
            torch.stack([f_q * uv[..., 1], -f_q * uv[..., 0]], dim=-1))

    def _t_wind(self, c, B):
        tau = c["fields"].get("wind_stress")
        if tau is None:
            return
        tau_q = self._any_cell_q(tau, vector=True)
        B["uv_cell"].add(tau_q / c["H_q"][..., None] / self.rho0)

    def _t_atm(self, c, B):
        pa = c["fields"].get("atmospheric_pressure")
        if pa is None:
            return
        B["uv_cell"].add(-self._any_cell_grad(pa) / self.rho0)

    def _t_qdrag(self, c, B):
        f = c["fields"]
        manning = f.get("manning_drag_coefficient")
        nikuradse = f.get("nikuradse_bed_roughness")
        cd = f.get("quadratic_drag_coefficient")
        H = c["H_q"]
        if manning is not None:
            if cd is not None:
                raise ValueError("cannot set both C_D and Manning")
            mu = self._any_cell_q(manning)
            C_D = self.g * mu**2 / torch.abs(H) ** (1.0 / 3.0)
        elif nikuradse is not None:
            z0 = self._any_cell_q(nikuradse)
            kappa = physical_constants["von_karman"]
            C_D = torch.where(
                H > z0,
                2 * kappa**2
                / torch.log(11.036 * torch.clamp_min(H / z0, 1.001)) ** 2,
                torch.zeros_like(H),
            )
        elif cd is not None:
            C_D = self._any_cell_q(cd)
        else:
            return
        alpha = float(getattr(self.options, "norm_smoother", 0.0))
        unorm = _safe_mag((c["uv_old_q"] ** 2).sum(-1) + alpha**2)
        B["uv_cell"].add(-(C_D * unorm / H)[..., None] * c["uv_q"])

    def _t_ldrag(self, c, B):
        C = c["fields"].get("linear_drag_coefficient")
        if C is None:
            return
        B["uv_cell"].add(-self._any_cell_q(C)[..., None] * c["uv_q"])

    def _t_bdrag(self, c, B):
        """Quadratic friction of the tangential velocity on 'drag' marked
        boundaries (ref L704-725)."""
        n = c["n"]
        for m, keys in sorted(self.bnd_keys.items()):
            if "drag" not in keys:
                continue
            C_D = facet_quad_value(self.asm, c["bnd_values"][m]["drag"])
            uv_b = c["uv_tr"][:, 0]
            uv_old_b = c["uv_old_tr"][:, 0]
            ut = uv_b - (uv_b * n).sum(-1)[..., None] * n
            ut_old = uv_old_b - (uv_old_b * n).sum(-1)[..., None] * n
            ut_mag = _safe_mag((ut_old**2).sum(-1))
            contrib = (-(C_D * ut_mag)[..., None] * ut
                       * self._mask_q(self.marker_masks[m], 1))
            B["uv_facet"].add(
                torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def _t_turbine(self, c, B):
        """Tidal turbine drag c_t density |u| u / H over the farms (ref
        L765-791); ``fields["turbine_density_{i}"]`` overrides farm i's
        density."""
        for i, farm in enumerate(self.tidal_farms):
            density_q = c["fields"].get(f"turbine_density_{i}",
                                        farm.turbine_density_q)
            unorm = _safe_mag((c["uv_old_q"] ** 2).sum(-1))
            c_t = farm.friction_coefficient_q(c["uv_old_q"], c["H_q"])
            B["uv_cell"].add(
                -(c_t * density_q * unorm / c["H_q"])[..., None]
                * c["uv_q"])

    def _t_mom_source(self, c, B):
        src = c["fields"].get("momentum_source")
        if src is not None:
            B["uv_cell"].add(self._any_cell_q(src, vector=True))

    def _t_cont_source(self, c, B):
        src = c["fields"].get("volume_source")
        if src is not None:
            B["eta_cell"].add(self._any_cell_q(src))

    # =========================== assembly ==============================
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        """Weak residual R such that M d(sol)/dt = R (reference sign
        convention, ``equation.py:14``).  Returns an swe_state dict of
        dof-space tensors (not mass-inverted)."""
        c = self.build_context(solution, solution_old, fields, bnd_values)
        c["_uv_dofs"] = solution["uv"]
        c["_uv_old_dofs"] = solution_old["uv"]
        c["_eta_old_dofs"] = solution_old["elev"]
        B = {
            k: Bucket()
            for k in ("uv_cell", "uv_grad", "uv_facet", "uv_fgrad",
                      "eta_cell", "eta_grad", "eta_facet")
        }
        for _, method in self.select_terms(label):
            method(c, B)
        asm = self.asm
        # out-of-place accumulation (never +=: the tensors may be shared)
        r_uv = torch.zeros_like(solution["uv"])
        r_eta = torch.zeros_like(solution["elev"])
        if B["uv_cell"] or B["eta_cell"]:
            uc = B["uv_cell"].val
            ec = B["eta_cell"].val
            if uc is not None and ec is not None:
                rr = asm.cell_to_dofs(torch.cat([uc, ec[..., None]], dim=-1))
                r_uv = r_uv + rr[..., 0:2]
                r_eta = r_eta + rr[..., 2]
            elif uc is not None:
                r_uv = r_uv + asm.cell_to_dofs(uc)
            else:
                r_eta = r_eta + asm.cell_to_dofs(ec)
        if B["uv_grad"] or B["eta_grad"]:
            ug = B["uv_grad"].val
            eg = B["eta_grad"].val
            if ug is not None and eg is not None:
                rr = asm.grad_to_dofs(
                    torch.cat([ug, eg[..., None, :]], dim=-2))
                r_uv = r_uv + rr[..., 0:2]
                r_eta = r_eta + rr[..., 2]
            elif ug is not None:
                r_uv = r_uv + asm.grad_to_dofs(ug)
            else:
                r_eta = r_eta + asm.grad_to_dofs(eg)
        if B["uv_facet"] or B["eta_facet"] or B["uv_fgrad"]:
            uf = B["uv_facet"].val
            ef = B["eta_facet"].val
            fg = B["uv_fgrad"].val
            if uf is not None and ef is not None:
                packed = torch.cat([uf, ef[..., None]], dim=-1)
                if fg is not None:
                    rr = asm.facet_fgrad_to_dofs(packed, fg)
                else:
                    rr = asm.facet_to_dofs(packed)
                r_uv = r_uv + rr[..., 0:2]
                r_eta = r_eta + rr[..., 2]
            else:
                if uf is not None:
                    r_uv = r_uv + asm.facet_to_dofs(uf)
                if ef is not None:
                    r_eta = r_eta + asm.facet_to_dofs(ef)
                if fg is not None:
                    r_uv = r_uv + asm.fgrad_to_dofs(fg)
        return swe_state(r_uv, r_eta)

    def mass_term(self, solution):
        """M(sol); with wetting-and-drying the continuity row gains the
        bathymetry-displacement term (ref L834-850, L914-920)."""
        asm = self.asm
        m_eta = asm.mass_apply(solution["elev"])
        if self.depth.use_wetting_and_drying:
            eta_q = asm.cell_values(solution["elev"])
            disp = self.depth.wd_displacement(self.bathy_q, eta_q,
                                              self.alpha_q)
            m_eta = m_eta + asm.cell_to_dofs(disp)
        return swe_state(asm.mass_apply(solution["uv"]), m_eta)

    def mass_inverse(self, r):
        """Exact block inverse (only a preconditioner under
        wetting-and-drying)."""
        return swe_state(self.mass_inverse_uv(r["uv"]),
                         self.mass_inverse_elev(r["elev"]))

    def mass_inverse_uv(self, r_uv):
        """The velocity block of :meth:`mass_inverse`."""
        return self.asm.mass_inverse(r_uv)

    def mass_inverse_elev(self, r_elev):
        """The elevation block of :meth:`mass_inverse`."""
        return self.asm.mass_inverse(r_elev)

    def assemble_operator_blocks(self, u_lag, fields, bnd_values, coeff,
                                 return_residual=False):
        """Exact component-major ring blocks (4, 9, 9, nc) of
        ``M - coeff*dR/du`` at the semi-implicit linearization
        (:func:`~thetis_tpu_torch.equations.swe_blocks.assemble_swe_blocks`)."""
        from .swe_blocks import assemble_swe_blocks

        return assemble_swe_blocks(self, u_lag, fields, bnd_values, coeff,
                                   return_residual=return_residual)


class ModeSplit2DEquations(ShallowWaterEquations):
    """Reduced depth-averaged system for mode splitting (port of the
    reference's ``ModeSplit2DEquations``, ``shallowwater_2d.py:713-737``).

    The barotropic momentum carries only the external pressure gradient,
    Coriolis, the 2D-3D coupling source (``momentum_source``: the depth
    average of the full 3D momentum tendency) and atmospheric pressure;
    advection, viscosity and bottom drag act on the 3D momentum and reach
    the 2D mode through the coupling source.  The continuity equation is
    the full HUDiv + volume source."""

    _MODESPLIT_TERMS = frozenset([
        "ExternalPressureGradientTerm",
        "CoriolisTerm",
        "MomentumSourceTerm",
        "AtmosphericPressureTerm",
        "HUDivTerm",
        "ContinuitySourceTerm",
    ])

    def __init__(self, mesh, asm, options, bathymetry, bnd_conditions=None):
        super().__init__(mesh, asm, options, bathymetry,
                         bnd_conditions=bnd_conditions)
        self.terms = [(n, l, m) for (n, l, m) in self.terms
                      if n in self._MODESPLIT_TERMS]
