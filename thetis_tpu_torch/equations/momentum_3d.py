r"""3D momentum equation for the mode-split deviation velocity.

Port of ``thetis_tpu/equations/momentum_3d.py``: the equation advances
the deviation velocity of the mode splitting; the depth average is
carried by the 2D system and re-imposed by the 3D step.

Terms:
  PressureGradientTerm     internal pressure gradient as a precomputed
                           field (``BaroclinicHeadCalculator``)
  HorizontalAdvectionTerm  upwinded inter-column momentum flux
  VerticalAdvectionTerm    inter-layer flux with w (ALE: w - w_mesh)
  CoriolisTerm             on the deviation from the 2D velocity
  HorizontalViscosityTerm  SIPG
  SourceTerm               interior momentum source
and :func:`vertical_viscosity_implicit`, the implicit column solve of the
vertical viscosity (both components in one tridiagonal launch).

Boundaries: a marker without a condition is an impermeable wall; an open
marker takes the 3D momentum vocabulary ``{'uv': value}`` (the external
velocity: a vector or a (nc, 3, nz, 2, 2) field), ``{'un': value}`` (its
normal component: a scalar or a (nc, 3, nz, 2) field) or ``{'symm':
None}`` (external = internal).  The advective flux there is
``avg(uv) avg(un)``; ``uv`` and ``un`` also enter the viscosity weakly.
"""
import torch

from .base import Bucket, EquationBase
from .turbulence import vdiff_implicit

__all__ = ["MomentumEquation3D", "vertical_viscosity_implicit"]


def _is_scalar(v):
    return not isinstance(v, torch.Tensor) or v.dim() == 0


class MomentumEquation3D(EquationBase):
    def __init__(self, mesh2d, asm3d, options, bnd_conditions=None):
        super().__init__(mesh2d, asm3d.asm2d, bnd_conditions)
        self.asm3d = asm3d
        self.options = options
        self.use_lf = bool(getattr(options, "use_lax_friedrichs_velocity",
                                   True))
        p = 1
        self.cp = (p + 1) * (p + 2) / 2.0
        self.sipg = float(getattr(options, "sipg_factor", 1.0))
        self.add_term("PressureGradientTerm", "implicit", self._t_pg)
        self.add_term("HorizontalAdvectionTerm", "explicit", self._t_hadv)
        self.add_term("VerticalAdvectionTerm", "explicit", self._t_vadv)
        self.add_term("CoriolisTerm", "explicit", self._t_coriolis)
        self.add_term("HorizontalViscosityTerm", "explicit", self._t_hvisc)
        self.add_term("SourceTerm", "source", self._t_source)

    def build_context(self, solution, fields, geom):
        a3 = self.asm3d
        c = {"fields": fields, "geom": geom}
        uv = solution["uv_3d"]
        c["uv_q"] = a3.cell_values(uv)       # (nc,nz,nq,nqv,2)
        c["uv_tr"] = a3.facet_traces(uv)     # (nf,2,nz,nqf,nqv,2)
        c["uv_below"], c["uv_above"] = a3.interface_values(uv)
        c["n"] = self.mesh.facet_normal[:, None, None, None, :]
        w = fields.get("w_3d")
        if w is not None:
            wm = fields.get("w_mesh_3d")
            w_rel = w if wm is None else w - wm
            c["w_rel"] = w_rel
            wb, wa = a3.interface_values(w_rel)
            c["w_if"] = 0.5 * (wb + wa)
        return c

    def _t_pg(self, c, B):
        """Internal pressure gradient ``+g grad_h(r)`` with
        ``r = -1/rho0 int_z^eta rho' dz``: with dense water on one side,
        the bottom accelerates toward the light side."""
        int_pg = c["fields"].get("int_pg_3d")
        if int_pg is not None:
            B["cell"].add(self.asm3d.cell_values(int_pg))

    def _t_hadv(self, c, B):
        """Upwinded momentum advection."""
        if not getattr(self.options, "use_nonlinear_equations", True):
            return
        n = c["n"]
        uv_q = c["uv_q"]
        # conservative flux d/dx_j (u_j u_k), tested against grad(test)
        B["grad"].add(uv_q[..., :, None] * uv_q[..., None, :])
        uv0, uv1 = c["uv_tr"][:, 0], c["uv_tr"][:, 1]
        un0 = (uv0 * n).sum(-1)
        un1 = (uv1 * n).sum(-1)
        un_av = 0.5 * (un0 + un1)
        s = 0.5 * (torch.sign(un_av) + 1.0)
        uv_up = uv0 * s[..., None] + uv1 * (1 - s[..., None])
        flux = uv_up * un_av[..., None]
        mi = self.mask_int.reshape(-1, 1, 1, 1, 1)
        B["vfacet"].add(torch.stack([-flux, flux], dim=1) * mi[:, None])
        if self.use_lf:
            gamma = 0.5 * torch.abs(un_av)[..., None]
            jmp = uv1 - uv0
            B["vfacet"].add(
                torch.stack([gamma * jmp, -gamma * jmp], dim=1) * mi[:, None])
        # land boundary: impermeable lateral walls (deviation velocity),
        # mirror-velocity LF penalty
        contrib = -2.0 * 0.5 * torch.abs(un0)[..., None] * un0[..., None] * n
        ml = self.mask_land.reshape(-1, 1, 1, 1, 1)
        B["vfacet"].add(
            torch.stack([contrib, torch.zeros_like(contrib)], dim=1)
            * ml[:, None])
        # open boundaries: the external state of the marker's condition,
        # flux = avg(uv) avg(un)
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            uv_ext = self._bnd_uv_ext(c, m, keys, uv0, n)
            un_av_b = 0.5 * (un0 + (uv_ext * n).sum(-1))
            contrib = -0.5 * (uv0 + uv_ext) * un_av_b[..., None]
            mk = self.marker_masks[m].reshape(-1, 1, 1, 1, 1)
            B["vfacet"].add(
                torch.stack([contrib, torch.zeros_like(contrib)], dim=1)
                * mk[:, None])

    def _t_vadv(self, c, B):
        """Vertical momentum advection."""
        if "w_if" not in c or not getattr(self.options,
                                          "use_nonlinear_equations", True):
            return
        w = c["w_if"][..., None]  # (nc, nz+1, nq, 1)
        ub, ua = c["uv_below"], c["uv_above"]
        s = 0.5 * (torch.sign(c["w_if"]) + 1.0)[..., None]
        uv_up = ub * s + ua * (1 - s)
        flux = uv_up * w
        zero = torch.zeros_like(flux[:, :1])
        flux = torch.cat([zero, flux[:, 1:-1], zero], dim=1)
        B["hfacet_below"].add(-flux)
        B["hfacet_above"].add(flux)
        wq = self.asm3d.cell_values(c["w_rel"])
        B["gradz"].add(c["uv_q"] * wq[..., None])

    def _t_coriolis(self, c, B):
        """Coriolis on the deviation from the 2D velocity
        (``coriolis_bg_uv_2d``): the 2D mode carries its own Coriolis
        term, and rotating the barotropic part here too would count it
        twice through the split residual."""
        f = c["fields"].get("coriolis")
        if f is None:
            return
        uv = c["uv_q"]  # (nc, nz, nq, nqv, 2)
        bg = c["fields"].get("coriolis_bg_uv_2d")
        if bg is not None:
            bg_q = self.asm3d.asm2d.cell_values(bg)  # (nc, nq, 2)
            uv = uv - bg_q[:, None, :, None, :]
        if not _is_scalar(f):
            if tuple(f.shape) != (self.mesh.nv,):
                raise ValueError("coriolis must be a scalar or a CG1 (nv,) "
                                 f"field, got {tuple(f.shape)}")
            # CG1 vertex field at the horizontal quad points, broadcast
            # over (nz, nqv)
            f = self.asm3d.asm2d.cell_values(
                f[self.mesh.cells])[:, None, :, None]  # (nc, 1, nq, 1)
        B["cell"].add(torch.stack([f * uv[..., 1], -f * uv[..., 0]], dim=-1))

    def _bnd_uv_ext(self, c, m, keys, uv_b, n):
        """The external velocity at open marker ``m``: ``uv`` (the full
        vector), ``un`` (the normal component) or ``symm`` (the internal
        trace ``uv_b``)."""
        vals = c["bnd_values"].get(m, {})
        if "uv" in keys:
            v = self.asm.as_tensor(vals["uv"])
            if v.dim() <= 1:
                return v.expand(uv_b.shape)
            return self.asm3d.facet_traces(v)[:, 0]
        if "un" in keys:
            v = self.asm.as_tensor(vals["un"])
            if v.dim() == 0:
                un_ext = v.expand(uv_b.shape[:-1])
            else:
                un_ext = self.asm3d.facet_traces(v)[:, 0]
            return un_ext[..., None] * n
        return uv_b

    def _nu_eval(self, nu):
        """Viscosity at cell quad points and facet traces: a scalar, or a
        3D dof field (nc, 3, nz, 2)."""
        if _is_scalar(nu):
            return nu, nu
        return self.asm3d.cell_values(nu), self.asm3d.facet_traces(nu)

    def _t_hvisc(self, c, B):
        """Horizontal SIPG viscosity: penalty, consistency and symmetry
        terms (same structure as the 2D SIPG)."""
        nu = c["fields"].get("viscosity_h")
        if nu is None:
            return
        a3 = self.asm3d
        scalar = _is_scalar(nu)
        nu_q, nu_tr = self._nu_eval(nu)
        g = a3.cell_grads(c["_dofs"], c["geom"])  # (..., 2comp, 3)
        gh = g[..., 0:2]
        stress_fac = nu_q if scalar else nu_q[..., None, None]
        B["grad"].add(-stress_fac * gh)

        sigma = self.sipg * self.cp / self.mesh.facet_l_normal
        sigma_max = torch.maximum(sigma[:, 0], sigma[:, 1]).reshape(
            -1, 1, 1, 1, 1)
        uv0, uv1 = c["uv_tr"][:, 0], c["uv_tr"][:, 1]
        n = c["n"]
        if scalar:
            nu_avg = nu_tr
        else:
            nu_avg = (0.5 * (nu_tr[:, 0] + nu_tr[:, 1]))[..., None]
        mi = self.mask_int.reshape(-1, 1, 1, 1, 1)
        # penalty: -sigma avg(nu) jump(u) tested with jump(test)
        pen = sigma_max * nu_avg * (uv0 - uv1)
        B["vfacet"].add(torch.stack([-pen, pen], dim=1) * mi[:, None])
        # consistency: + avg(nu grad_h(u)) . n tested with jump(test)
        gtr = a3.facet_trace_grads_h(c["_dofs"], c["geom"])
        # (nf, 2, nz, nqf, nqv, 2comp, 2dir)
        stress_tr = nu_tr * gtr if scalar else nu_tr[..., None, None] * gtr
        avg_stress_n = (
            0.5 * (stress_tr[:, 0] + stress_tr[:, 1]) * n[..., None, :]
        ).sum(-1)
        B["vfacet"].add(
            torch.stack([avg_stress_n, -avg_stress_n], dim=1) * mi[:, None])
        # symmetry: + avg(nu grad_h(test)) . jump(u, n)
        nu_s = nu_avg if scalar else nu_avg[..., None]
        SJ = nu_s * (uv0 - uv1)[..., :, None] * n[..., None, :]
        mi2 = self.mask_int.reshape(-1, 1, 1, 1, 1, 1)
        B["vfacet_grad"].add(
            torch.stack([0.5 * SJ, 0.5 * SJ], dim=1) * mi2[:, None])
        # open boundaries whose condition prescribes uv or un: the
        # external data enter weakly (Dirichlet by Nitsche)
        stress_bn = (stress_tr[:, 0] * n[..., None, :]).sum(-1)
        sigma_b = sigma[:, 0].reshape(-1, 1, 1, 1, 1)
        nu0 = nu_tr if scalar else nu_tr[:, 0][..., None, None]
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None or not ({"uv", "un"} & keys):
                continue
            uv_ext = self._bnd_uv_ext(c, m, keys, uv0, n)
            if "un" in keys:
                delta_uv = ((uv0 - uv_ext) * n).sum(-1)[..., None] * n
            else:
                delta_uv = uv0 - uv_ext
            SJb = nu0 * delta_uv[..., :, None] * n[..., None, :]
            SJbn = (SJb * n[..., None, :]).sum(-1)
            mk = self.marker_masks[m].reshape(-1, 1, 1, 1, 1)
            contrib = (-sigma_b * SJbn + stress_bn) * mk
            B["vfacet"].add(
                torch.stack([contrib, torch.zeros_like(contrib)], dim=1))
            SJb = SJb * mk[..., None]
            B["vfacet_grad"].add(
                torch.stack([SJb, torch.zeros_like(SJb)], dim=1))

    def _t_source(self, c, B):
        src = c["fields"].get("momentum_source_3d")
        if src is not None:
            B["cell"].add(self.asm3d.cell_values(src))

    # -- assembly --------------------------------------------------------
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values, geom=None):
        if geom is None:
            raise ValueError("MomentumEquation3D.residual needs geom")
        c = self.build_context(solution, fields, geom)
        c["_dofs"] = solution["uv_3d"]
        c["bnd_values"] = bnd_values or {}
        B = {k: Bucket() for k in (
            "cell", "grad", "gradz", "vfacet", "vfacet_grad",
            "hfacet_below", "hfacet_above")}
        for _, method in self.select_terms(label):
            method(c, B)
        a3 = self.asm3d
        r = torch.zeros_like(solution["uv_3d"])
        if B["cell"]:
            r = r + a3.cell_to_dofs(B["cell"].val, geom)
        if B["grad"] or B["gradz"]:
            gh = (B["grad"].val if B["grad"]
                  else c["uv_q"].new_zeros(c["uv_q"].shape + (2,)))
            gz = B["gradz"].val if B["gradz"] else torch.zeros_like(c["uv_q"])
            r = r + a3.grad_to_dofs(torch.cat([gh, gz[..., None]], dim=-1),
                                    geom)
        if B["vfacet"]:
            r = r + a3.vfacet_to_dofs(B["vfacet"].val, geom)
        if B["vfacet_grad"]:
            r = r + a3.vfacet_grad_to_dofs(B["vfacet_grad"].val, geom)
        if B["hfacet_below"] or B["hfacet_above"]:
            zb = torch.zeros_like(c["uv_below"])
            r = r + a3.hfacet_to_dofs(
                B["hfacet_below"].val if B["hfacet_below"] else zb,
                B["hfacet_above"].val if B["hfacet_above"] else zb, geom)
        return {"uv_3d": r}

    def mass_term(self, solution, geom):
        return {"uv_3d": self.asm3d.mass_apply(solution["uv_3d"], geom)}

    def mass_inverse(self, r, geom):
        return {"uv_3d": self.asm3d.mass_inverse(r["uv_3d"], geom)}


def vertical_viscosity_implicit(uv, nu_v, Dn, dt, stress_top=None,
                                bottom_drag=None, uv_bot=None):
    r"""Backward-Euler implicit vertical viscosity column solve for both
    velocity components, with optional surface stress flux and quadratic
    bottom friction:

      du/dt = d/dz(nu du/dz),  nu du/dz|_s = tau/rho0,
      nu du/dz|_b = C_d |u_b| u_b.

    Both components ride one batched column solve (leading axis), so the
    tridiagonal kernel launches once.
    """
    rhs = uv.movedim(-1, 0)                              # (2, nc, 3, nz, 2)
    if stress_top is not None or (bottom_drag is not None
                                  and uv_bot is not None):
        rhs = rhs.clone()
    if stress_top is not None:
        v_top = torch.clamp_min(0.5 * Dn[..., -1], 1e-12)
        rhs[..., -1, 1] += dt * stress_top.movedim(-1, 0) / v_top
    if bottom_drag is not None and uv_bot is not None:
        ub_mag = torch.sqrt((uv_bot**2).sum(-1) + 1e-14)
        v_bot = torch.clamp_min(0.5 * Dn[..., 0], 1e-12)
        rhs[..., 0, 0] += (-dt * bottom_drag * ub_mag
                           * uv_bot.movedim(-1, 0) / v_bot)
    return vdiff_implicit(rhs, nu_v, Dn, dt).movedim(0, -1)
