r"""rt-dg element family for the 2D shallow-water equations (port of
``thetis_tpu/equations/shallowwater_rtdg.py``).

The reference's ``element_family = 'rt-dg'`` (``solver2d.py:307-336``):
velocity in a Raviart-Thomas H(div) space, elevation in DG.  This is the
lowest-order mimetic member **RT1 x P0** (``polynomial_degree = 0``; with
:class:`~thetis_tpu_torch.fem.bdm.BDMSpace` the ``bdm-dg`` BDM1 x P0):
facet normal velocities and cell-mean elevations, the finite-element
form of the staggered C-grid, exactly mass conservative with
single-valued facet fluxes.

Weak forms follow the reference terms specialised to this pair:

* ExternalPressureGradientTerm (ref ``shallowwater_eq.py:335-381``): by
  parts, ``+g eta div(psi)`` in cells; interior facet terms vanish
  because the RT test has a continuous normal component; boundaries get
  the linear-Riemann elevation.
* HUDivTerm (ref L396-450): pure facet flux ``F = H*(u.n)*`` with the
  Riemann elevation correction, exactly conservative.
* Coriolis (on a sphere ``-f (n_cell x u)``, the reference's CellNormal
  form), drag, sources: cell integrals against psi.
* HorizontalAdvectionTerm (ref L453-510): conservative cell term against
  grad(psi) plus upwinded facet fluxes.

Solution dict: ``{'uv': (nf,) or (nf, 2), 'elev': (nc, 1)}``.
"""
import numpy as np
import torch

from ..config import physical_constants
from .base import EquationBase

__all__ = ["ShallowWaterEquationsRTDG"]


class ShallowWaterEquationsRTDG(EquationBase):
    def __init__(self, mesh, asm, rt_space, options, bathymetry,
                 bnd_conditions=None):
        if getattr(options, "use_wetting_and_drying", False):
            raise ValueError(
                "wetting-and-drying requires the dg-dg element family")
        super().__init__(mesh, asm, bnd_conditions)
        self.rt = rt_space
        self.options = options
        self.g = float(physical_constants["g_grav"])

        # per-cell and per-facet bathymetry (P0 means)
        self.bathy_c = self._cell_mean(bathymetry)          # (nc,)
        fc = mesh.facet_cells
        self.bathy_f = 0.5 * (self.bathy_c[fc[:, 0]]
                              + self.bathy_c[fc[:, 1]])
        self.area = mesh.cell_area                           # (nc,)
        self.flen = mesh.facet_len                           # (nf,)
        self.fcells = fc                                     # (nf, 2)
        self.sigma = torch.as_tensor(rt_space.sigma_np, dtype=mesh.dtype,
                                     device=mesh.device)     # (nc, 3)
        self.cell_facets = torch.as_tensor(
            rt_space.cell_facets_np.astype(np.int64), device=mesh.device)

        self.add_term("ExternalPressureGradientTerm", "implicit",
                      self._t_epg)
        self.add_term("HUDivTerm", "implicit", self._t_hudiv)
        self.add_term("HorizontalAdvectionTerm", "implicit", self._t_hadv)
        self.add_term("CoriolisTerm", "implicit", self._t_coriolis)
        self.add_term("QuadraticDragTerm", "implicit", self._t_qdrag)
        self.add_term("LinearDragTerm", "implicit", self._t_ldrag)
        self.add_term("MomentumSourceTerm", "source", self._t_mom_source)
        self.add_term("ContinuitySourceTerm", "source", self._t_cont_source)

    # ------------------------------------------------------------------
    def _tensor(self, val):
        return torch.as_tensor(val, dtype=self.mesh.dtype,
                               device=self.mesh.device)

    def _cell_mean(self, val):
        """A coefficient as one value a cell (nc,): a scalar, a CG1
        vertex field (nv,), per-cell dofs (nc, ...) or (nc,)."""
        mesh = self.mesh
        val = self._tensor(val)
        if val.dim() == 0:
            return val.expand(mesh.nc)
        if val.shape[0] == mesh.nv:
            return val[mesh.cells].mean(dim=1)
        if val.dim() >= 2 and val.shape[0] == mesh.nc:
            return val.reshape(mesh.nc, -1).mean(dim=1)
        if tuple(val.shape) == (mesh.nc,):
            return val
        raise ValueError(
            f"cannot reduce coefficient of shape {tuple(val.shape)}")

    def _facet_scalar(self, val):
        """A BC value or coefficient as one value a facet (nf,)."""
        mesh = self.mesh
        val = self._tensor(val)
        if val.dim() == 0:
            return val.expand(mesh.nf)
        if val.shape[0] == mesh.nv:
            fv = mesh.facet_verts
            return 0.5 * (val[fv[:, 0]] + val[fv[:, 1]])
        if tuple(val.shape) == (mesh.nf,):
            return val
        if val.shape[0] == mesh.nc:  # cell data: the mean of both sides
            cm = val.reshape(mesh.nc, -1).mean(dim=1)
            return 0.5 * (cm[self.fcells[:, 0]] + cm[self.fcells[:, 1]])
        raise ValueError(
            f"cannot map BC value of shape {tuple(val.shape)}")

    def _bnd_ext(self, eta_f, un_f, bnd_values):
        """Per-facet external (eta_ext, un_ext) from the weak BC
        vocabulary (ref ``shallowwater_eq.py:232-272``); meaningful on
        open-boundary facets only."""
        eta_ext = eta_f
        un_ext = un_f
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            vals = bnd_values[m]
            mask = self.marker_masks[m]
            e_m = (self._facet_scalar(vals["elev"])
                   if "elev" in keys else eta_f)
            if "un" in keys:
                u_m = self._facet_scalar(vals["un"])
            elif "flux" in keys:
                H = torch.clamp_min(self.bathy_f + e_m, 0.05)
                area = H * self.mesh.boundary_len.get(m, 1.0)
                u_m = self._facet_scalar(vals["flux"]) / area
            elif "uv" in keys:
                v = self._tensor(vals["uv"])
                u_m = ((v[None, :] * self.mesh.facet_normal).sum(-1)
                       if v.dim() == 1 else un_f)
            else:
                u_m = un_f
            eta_ext = torch.where(mask, e_m, eta_ext)
            un_ext = torch.where(mask, u_m, un_ext)
        return eta_ext, un_ext

    # ------------------------------------------------------------------
    def build_context(self, solution, solution_old, fields, bnd_values):
        rt = self.rt
        U, eta = solution["uv"], solution["elev"][:, 0]
        eta_old = solution_old["elev"][:, 0]
        c = {"fields": fields, "U": U, "eta": eta}
        c["uv_q"] = rt.cell_values(U)                  # (nc, nq, gdim)
        fc = self.fcells
        c["eta0"], c["eta1"] = eta[fc[:, 0]], eta[fc[:, 1]]
        H_c = self.bathy_c + (eta_old if getattr(
            self.options, "use_nonlinear_equations", True) else 0.0)
        c["H_c"] = torch.clamp_min(H_c, 0.05)
        c["H_f"] = torch.clamp_min(
            0.5 * (c["H_c"][fc[:, 0]] + c["H_c"][fc[:, 1]]), 0.05)
        c["un_mean"] = rt.facet_un_mean(U)
        c["eta_ext"], c["un_ext"] = self._bnd_ext(
            c["eta0"], c["un_mean"], bnd_values)
        return c

    # ============================ terms ================================
    def _t_epg(self, c, B):
        g = self.g
        rt = self.rt
        nq = rt.wdetJ.shape[1]
        eta_q = c["eta"][:, None].expand(self.mesh.nc, nq)
        B["uv"] = B.get("uv", 0.0) + rt.div_to_dofs(g * eta_q)
        # boundary: -g eta_rie against the own-facet normal trace
        # (interior terms cancel by H(div) conformity)
        srt = torch.sqrt(c["H_f"] / g)
        eta_b = c["eta0"]
        un = c["un_mean"]
        eta_rie_open = (0.5 * (eta_b + c["eta_ext"])
                        + srt * (un - c["un_ext"]))
        eta_rie_land = eta_b + srt * un
        eta_rie = torch.where(self.mask_open, eta_rie_open, eta_rie_land)
        Fq = torch.where(self.mask_bnd, g * eta_rie,
                         torch.zeros_like(eta_rie))[:, None]
        B["uv"] = B["uv"] - rt.bnd_normal_to_dofs(
            Fq.expand(self.mesh.nf, rt.wlen.shape[1]))

    def _t_hudiv(self, c, B):
        g = self.g
        un = c["un_mean"]
        srt_int = torch.sqrt(g / c["H_f"])
        # interior Riemann flux: F = H (u.n + 0.5 sqrt(g/H) jump(eta))
        F_int = c["H_f"] * (un + 0.5 * srt_int * (c["eta0"] - c["eta1"]))
        # boundary: land -> 0; open -> linear Riemann with external state
        un_rie = (0.5 * (un + c["un_ext"])
                  + 0.5 * srt_int * (c["eta0"] - c["eta_ext"]))
        F_bnd = torch.where(self.mask_open, c["H_f"] * un_rie,
                            torch.zeros_like(un_rie))
        F = torch.where(self.mask_bnd, F_bnd, F_int) * self.flen
        # continuity rows: d(eta)/dt A_c = -sum_f sigma_cf F_f
        loc = -F[self.cell_facets] * self.sigma
        B["eta"] = B.get("eta", 0.0) + loc.sum(dim=1)

    def _t_hadv(self, c, B):
        if not getattr(self.options, "use_nonlinear_equations", True):
            return
        rt = self.rt
        uv_q = c["uv_q"]
        # cell: +(u x u) : grad(psi)
        G = uv_q[..., :, None] * uv_q[..., None, :]
        B["uv"] = B.get("uv", 0.0) + rt.grad_to_dofs(G)
        # facet: upwinded -(u_up un) . psi from each side
        tr = rt.facet_traces(c["U"])                 # (nf, 2, nqf, gdim)
        un = rt.facet_un_quad(c["U"])                # (nf, nqf) along n_f
        s = 0.5 * (torch.sign(un) + 1.0)             # 1 if flow 0 -> 1
        u_up = tr[:, 0] * s[..., None] + tr[:, 1] * (1.0 - s)[..., None]
        flux = u_up * un[..., None]
        mi = self.mask_int.reshape(-1, 1, 1)
        Ff = torch.stack([-flux, flux], dim=1) * mi[:, None]
        # boundary closure of the by-parts form (ref L213-246): momentum
        # carried through open boundaries with the side-0 trace
        flux_b = tr[:, 0] * un[..., None]
        mb = self.mask_bnd.reshape(-1, 1, 1)
        Ff = Ff + torch.stack([-flux_b, torch.zeros_like(flux_b)],
                              dim=1) * mb[:, None]
        B["uv"] = B["uv"] + rt.facet_to_dofs(Ff)

    def _t_coriolis(self, c, B):
        f = c["fields"].get("coriolis")
        if f is None:
            return
        f_q = self._cell_mean(f)[:, None]
        u = c["uv_q"]
        if hasattr(self.mesh, "cell_normal"):
            # manifold mesh: -f (n_cell x u), the reference's CellNormal
            # Coriolis (ref shallowwater_eq.py:627-630)
            n = self.mesh.cell_normal[:, None, :].expand_as(u)
            Fq = -f_q[..., None] * torch.linalg.cross(n, u, dim=-1)
        else:
            Fq = torch.stack([f_q * u[..., 1], -f_q * u[..., 0]], dim=-1)
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(Fq)

    def _t_qdrag(self, c, B):
        fields = c["fields"]
        Cd = fields.get("quadratic_drag_coefficient")
        mu = fields.get("manning_drag_coefficient")
        if Cd is None and mu is None:
            return
        H_q = torch.clamp_min(c["H_c"], 0.05)[:, None]
        if mu is not None:
            mu_c = self._cell_mean(mu)[:, None]
            Cd_q = self.g * mu_c**2 / H_q ** (1.0 / 3.0)
        else:
            Cd_q = self._cell_mean(Cd)[:, None]
        u = c["uv_q"]
        umag = torch.sqrt((u**2).sum(-1) + 1e-12)
        Fq = -Cd_q[..., None] * umag[..., None] * u / H_q[..., None]
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(Fq)

    def _t_ldrag(self, c, B):
        C = c["fields"].get("linear_drag_coefficient")
        if C is None:
            return
        C_q = self._cell_mean(C)[:, None, None]
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(-C_q * c["uv_q"])

    def _t_mom_source(self, c, B):
        src = c["fields"].get("momentum_source")
        if src is None:
            return
        v = self._tensor(src)
        nq = self.rt.wdetJ.shape[1]
        if v.dim() == 1:  # constant vector
            Fq = v.expand(self.mesh.nc, nq, 2)
        else:  # per-node/cell vector field: cell means per component
            comp = [self._cell_mean(v[..., k]) for k in range(2)]
            Fq = torch.stack(comp, dim=-1)[:, None, :].expand(
                self.mesh.nc, nq, 2)
        B["uv"] = B.get("uv", 0.0) + self.rt.cell_to_dofs(Fq)

    def _t_cont_source(self, c, B):
        src = c["fields"].get("volume_source")
        if src is None:
            return
        B["eta"] = B.get("eta", 0.0) + self._cell_mean(src) * self.area

    # =========================== assembly ==============================
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        c = self.build_context(solution, solution_old, fields, bnd_values)
        B = {}
        for _, method in self.select_terms(label):
            method(c, B)
        r_uv = B.get("uv")
        r_eta = B.get("eta")
        if r_uv is None:
            r_uv = torch.zeros_like(solution["uv"])
        if r_eta is None:
            r_eta = torch.zeros_like(solution["elev"][:, 0])
        return {"uv": r_uv, "elev": r_eta[:, None]}

    def mass_term(self, solution):
        return {"uv": self.rt.mass_apply(solution["uv"]),
                "elev": self.area[:, None] * solution["elev"]}

    def mass_inverse(self, r):
        return {"uv": self.mass_inverse_uv(r["uv"]),
                "elev": self.mass_inverse_elev(r["elev"])}

    def mass_inverse_uv(self, r_uv):
        return self.rt.mass_inverse(r_uv)

    def mass_inverse_elev(self, r_elev):
        return r_elev / self.area[:, None]

    def norm_elev(self, eta):
        return torch.sqrt((self.area * (eta[:, 0] ** 2)).sum())

    def norm_uv(self, U):
        return torch.sqrt(torch.clamp_min(
            (U * self.rt.mass_apply(U)).sum(), 0.0))
