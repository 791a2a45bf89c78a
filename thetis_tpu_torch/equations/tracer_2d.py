r"""2D tracer advection-diffusion equations.

Port of ``thetis_tpu/equations/tracer_2d.py`` (the reference term set of
``thetis/tracer_eq_2d.py``):

  HorizontalAdvectionTerm   (ref L124-193)  explicit: upwind interface flux
  HorizontalDiffusionTerm   (ref L196-278)  explicit: SIPG
  SourceTerm                (ref L281-298)  source
  Conservative* variants    (ref L301-445)

Several tracers form a system solved together: the solution is a dict
``{label: (nc, nd)}`` (CG1: ``{label: (nv,)}``).  Boundary conditions use
the tracer vocabulary of ref L78-115: per-marker dicts with ``value``
(external tracer, for every label) or ``value-<label>``, ``elev``/``uv``/
``un``/``flux`` (external flow) and ``diff_flux``.  The depth is the
shallow-water equation's :class:`~.shallowwater_2d.DepthExpression`, so
wetting-and-drying reaches the conservative forms.

The optional ``tracer_advective_velocity_factor`` field scales the
advective velocity (ref L105, L151).
"""
import numpy as np
import torch

from ..solvers.pcg import JacobiPCG
from .base import Bucket, EquationBase, facet_quad_value, facet_quad_value_2s

__all__ = ["TracerEquation2D", "TracerEquation2DCG"]


def _is_field(v, ndim):
    return isinstance(v, torch.Tensor) and v.dim() >= ndim


class TracerEquation2D(EquationBase):
    def __init__(self, mesh, asm, options, bathymetry, labels,
                 bnd_conditions=None, depth=None):
        """
        :arg labels: list of tracer labels in the system
        :arg bnd_conditions: {marker: {key: value}}; tracer-specific
            external values use key 'value' (every label) or
            f'value-{label}'.
        """
        super().__init__(mesh, asm, bnd_conditions)
        self.options = options
        self.labels = list(labels)
        if depth is None:
            from .shallowwater_2d import DepthExpression

            depth = DepthExpression(use_nonlinear_equations=True)
        self.depth = depth
        self.bathy_tr0 = facet_quad_value(asm, bathymetry)
        self.bathy_q = None  # evaluated on demand for the conservative source
        self.bathymetry = bathymetry
        tr_opts = getattr(options, "tracer", {})
        self.conservative = {
            l: (bool(getattr(tr_opts.get(l, None), "use_conservative_form",
                             False))
                if isinstance(tr_opts, dict) else False)
            for l in self.labels
        }
        self.use_lf = bool(getattr(options, "use_lax_friedrichs_tracer",
                                   False))
        self.sipg_factor = float(getattr(options, "sipg_factor_tracer", 1.0))
        p = asm.space.degree
        self.cp = (p + 1) * (p + 2) / 2.0

        self.add_term("HorizontalAdvectionTerm", "explicit", self._t_adv)
        self.add_term("HorizontalDiffusionTerm", "explicit", self._t_diff)
        self.add_term("SourceTerm", "source", self._t_source)

    # -- helpers --------------------------------------------------------
    def _bnd_flow_ext(self, eta_b, uv_b, fields, bnd_values):
        """External velocity at boundary quad points per ref
        ``tracer_eq_2d.py:78-115``."""
        asm = self.asm
        uv_ext = uv_b
        nf_n = self.mesh.facet_normal[:, None, :]
        corr = fields.get("tracer_advective_velocity_factor", 1.0)
        if _is_field(corr, 1):
            # boundary trace of the factor, broadcast over components
            corr = facet_quad_value(asm, corr)[..., None]
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            vals = bnd_values[m]
            mask1 = self._mask_q(self.marker_masks[m], 1)
            if "elev" in keys:
                e_m = facet_quad_value(asm, vals["elev"])
            else:
                e_m = eta_b
            if "uv" in keys:
                u_m = corr * facet_quad_value(asm, vals["uv"], vector=True)
            elif "flux" in keys:
                h_ext = self.depth.total_depth(self.bathy_tr0, e_m)
                area = h_ext * self.mesh.boundary_len.get(m, 1.0)
                u_m = corr * (facet_quad_value(asm, vals["flux"])
                              / area)[..., None] * nf_n
            elif "un" in keys:
                u_m = facet_quad_value(asm, vals["un"])[..., None] * nf_n
            else:
                u_m = uv_b
            uv_ext = torch.where(mask1, u_m, uv_ext)
        return uv_ext

    def _c_ext(self, label, c_b, bnd_values):
        c_ext = c_b
        for m in self.open_markers:
            keys = self.bnd_keys.get(m)
            if keys is None:
                continue
            key = (f"value-{label}" if f"value-{label}" in keys
                   else ("value" if "value" in keys else None))
            if key is None:
                continue
            mask = self._mask_q(self.marker_masks[m])
            c_ext = torch.where(
                mask, facet_quad_value(self.asm, bnd_values[m][key]), c_ext)
        return c_ext

    # -- context --------------------------------------------------------
    def build_context(self, solution, solution_old, fields, bnd_values):
        asm = self.asm
        c = {"fields": fields, "bnd_values": bnd_values}
        uv_dofs = fields.get("uv_2d")
        corr = fields.get("tracer_advective_velocity_factor", 1.0)
        if uv_dofs is not None:
            # the advective-velocity factor multiplies at dof level (a
            # Function product in the reference, ref L154)
            if _is_field(corr, 2):
                uv_dofs = uv_dofs * corr[..., None]
            else:
                uv_dofs = uv_dofs * corr
            c["uv_q"] = asm.cell_values(uv_dofs)
            uv_grad = asm.cell_grads(uv_dofs)
            c["div_uv_q"] = uv_grad[..., 0, 0] + uv_grad[..., 1, 1]
            c["uv_tr"] = asm.facet_traces(uv_dofs)
        elev = fields.get("elev_2d")
        c["eta_tr0"] = (facet_quad_value(asm, elev) if elev is not None
                        else torch.zeros_like(self.bathy_tr0))
        c["n"] = self.mesh.facet_normal[:, None, :]
        if uv_dofs is not None:
            c["uv_ext"] = self._bnd_flow_ext(
                c["eta_tr0"], c["uv_tr"][:, 0], fields, bnd_values)
        c["c_q"] = {l: asm.cell_values(solution[l]) for l in self.labels}
        c["c_tr"] = {l: asm.facet_traces(solution[l]) for l in self.labels}
        return c

    # =========================== terms =================================
    def _t_adv(self, c, B):
        if "uv_q" not in c:
            return
        n = c["n"]
        un0 = (c["uv_tr"][:, 0] * n).sum(-1)
        un1 = (c["uv_tr"][:, 1] * n).sum(-1)
        un_av = 0.5 * (un0 + un1)
        s = 0.5 * (torch.sign(un_av) + 1.0)
        mi = self._mask_q(self.mask_int)
        lf = c["fields"].get("lax_friedrichs_tracer_scaling_factor", 1.0)
        uv_ext = c.get("uv_ext")
        for l in self.labels:
            cq = c["c_q"][l]
            c0, c1 = c["c_tr"][l][:, 0], c["c_tr"][l][:, 1]
            cons = self.conservative[l]
            if cons:
                # conservative: flux_up = (c uv) upwinded (ref L354-395)
                B[l + "_grad"].add(cq[..., None] * c["uv_q"])
                flux_up_n = (c0 * un0) * s + (c1 * un1) * (1 - s)
                B[l + "_facet"].add(
                    torch.stack([-flux_up_n, flux_up_n], dim=1)
                    * mi[:, None])
            else:
                # nonconservative (ref L147-193)
                B[l + "_cell"].add(cq * c["div_uv_q"])
                B[l + "_grad"].add(cq[..., None] * c["uv_q"])
                c_up = c0 * s + c1 * (1 - s)
                B[l + "_facet"].add(
                    torch.stack([-c_up * un0, c_up * un1], dim=1)
                    * mi[:, None])
            if self.use_lf:
                gamma = 0.5 * torch.abs(un_av) * lf
                jmp = c1 - c0
                B[l + "_facet"].add(
                    torch.stack([gamma * jmp, -gamma * jmp], dim=1)
                    * mi[:, None])
            # boundary
            c_b = c["c_tr"][l][:, 0]
            uv_b = c["uv_tr"][:, 0]
            un_b = (uv_b * n).sum(-1)
            c_ext = self._c_ext(l, c_b, c["bnd_values"])
            un_av_b = (0.5 * (uv_b + uv_ext) * n).sum(-1)
            s_b = 0.5 * (torch.sign(un_av_b) + 1.0)
            if cons:
                fl_open = ((c_b * un_b) * s_b
                           + (c_ext * (uv_ext * n).sum(-1)) * (1 - s_b))
            else:
                fl_open = (c_b * s_b + c_ext * (1 - s_b)) * un_av_b
            fl_closed = c_b * un_b  # outflow of the internal value
            contrib = -torch.where(self._mask_q(self.mask_open), fl_open,
                                   fl_closed) * self._mask_q(self.mask_bnd)
            B[l + "_facet"].add(
                torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def _t_diff(self, c, B):
        asm = self.asm
        n = c["n"]
        mi = self._mask_q(self.mask_int)
        mi2 = self._mask_q(self.mask_int, 1)
        ln = self.mesh.facet_l_normal
        sigma = self.sipg_factor * self.cp / ln
        sigma_max = torch.maximum(sigma[:, 0], sigma[:, 1])[:, None]
        for l in self.labels:
            mu_f = c["fields"].get(f"diffusivity_h-{l}")
            if mu_f is None:
                continue
            mu_q = self._coeff_q(mu_f)
            mu_tr = facet_quad_value_2s(asm, mu_f)
            grad_c = asm.cell_grads(c["_dofs"][l])
            B[l + "_grad"].add(-mu_q[..., None] * grad_c)
            c0, c1 = c["c_tr"][l][:, 0], c["c_tr"][l][:, 1]
            mu_avg = 0.5 * (mu_tr[:, 0] + mu_tr[:, 1])
            djump = c0 - c1
            # penalty (ref L251-253)
            pen = sigma_max * mu_avg * djump
            B[l + "_facet"].add(torch.stack([-pen, pen], dim=1)
                                * mi[:, None])
            # -avg(mu grad(test)) . jump(c, n)  (ref L254-255)
            fg = torch.stack(
                [0.5 * mu_tr[:, 0, :, None] * djump[..., None] * n,
                 0.5 * mu_tr[:, 1, :, None] * djump[..., None] * n], dim=1)
            B[l + "_fgrad"].add(fg * mi2[:, None])
            # -jump(test, n) . avg(mu grad(c))  (ref L256-257)
            gtr = asm.facet_trace_grads(c["_dofs"][l])
            flux_avg_n = (0.5 * (mu_tr[:, 0, :, None] * gtr[:, 0]
                                 + mu_tr[:, 1, :, None] * gtr[:, 1])
                          * n).sum(-1)
            B[l + "_facet"].add(
                torch.stack([flux_avg_n, -flux_avg_n], dim=1) * mi[:, None])
            # boundary (ref L259-277)
            for m in sorted(self.bnd_keys):
                keys = self.bnd_keys[m]
                mask = self._mask_q(self.marker_masks[m])
                if "diff_flux" in keys:
                    df = facet_quad_value(asm,
                                          c["bnd_values"][m]["diff_flux"])
                    contrib = df * mask
                elif m in self.open_markers:
                    # consistency flux with upwinded c (the external
                    # data's gradient taken as 0)
                    uv_b = c.get("uv_tr")
                    if uv_b is None:
                        continue
                    un_av_b = (0.5 * (uv_b[:, 0] + c["uv_ext"]) * n).sum(-1)
                    s_b = 0.5 * (torch.sign(un_av_b) + 1.0)
                    flux_n = (mu_tr[:, 0, :, None] * gtr[:, 0] * n).sum(-1)
                    contrib = s_b * flux_n * mask
                else:
                    continue
                B[l + "_facet"].add(
                    torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def _t_source(self, c, B):
        for l in self.labels:
            src = c["fields"].get(f"source-{l}")
            if src is None:
                continue
            src_q = self._coeff_q(src)
            if self.conservative[l]:
                if self.bathy_q is None:
                    self.bathy_q = self._coeff_q(self.bathymetry)
                elev = c["fields"].get("elev_2d")
                eta_q = (self._coeff_q(elev) if elev is not None
                         else torch.zeros_like(self.bathy_q))
                H_q = self.depth.total_depth(self.bathy_q, eta_q)
                B[l + "_cell"].add(H_q * src_q)
            else:
                B[l + "_cell"].add(src_q)

    def _coeff_q(self, val):
        asm, mesh = self.asm, self.mesh
        nq = len(asm.space._tab_np["qw"])
        if np.isscalar(val) or (hasattr(val, "ndim") and val.ndim == 0):
            return asm.as_tensor(val).expand(mesh.nc, nq)
        val = asm.as_tensor(val)
        if val.shape[:1] == (mesh.nv,):
            return asm.cg1_values(val[mesh.cells])
        if val.shape[:2] == (mesh.nc, asm.ndofs):
            return asm.cell_values(val)
        if val.shape[:2] == (mesh.nc, 1):
            return val[:, :1].expand(mesh.nc, nq)
        raise ValueError(f"bad coefficient shape {tuple(val.shape)}")

    # =========================== assembly ==============================
    def _buckets(self, solution, solution_old, fields, bnd_values, label):
        c = self.build_context(solution, solution_old, fields, bnd_values)
        c["_dofs"] = solution
        B = {l + kind: Bucket() for l in self.labels
             for kind in ("_cell", "_grad", "_facet", "_fgrad")}
        for _, method in self.select_terms(label):
            method(c, B)
        return c, B

    def _project(self, r, B, l):
        asm = self.asm
        if B[l + "_cell"]:
            r = r + asm.cell_to_dofs(B[l + "_cell"].val)
        if B[l + "_grad"]:
            r = r + asm.grad_to_dofs(B[l + "_grad"].val)
        if B[l + "_facet"] and B[l + "_fgrad"]:
            r = r + asm.facet_fgrad_to_dofs(B[l + "_facet"].val,
                                            B[l + "_fgrad"].val)
        elif B[l + "_facet"]:
            r = r + asm.facet_to_dofs(B[l + "_facet"].val)
        elif B[l + "_fgrad"]:
            r = r + asm.fgrad_to_dofs(B[l + "_fgrad"].val)
        return r

    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        """Weak residual per label (not mass-inverted).  The tracer terms
        use the fields the stepper passes as ``fields``."""
        _, B = self._buckets(solution, solution_old, fields, bnd_values,
                             label)
        return {l: self._project(torch.zeros_like(solution[l]), B, l)
                for l in self.labels}

    def mass_term(self, solution):
        return {l: self.asm.mass_apply(solution[l]) for l in self.labels}

    def mass_inverse(self, r):
        return {l: self.asm.mass_inverse(r[l]) for l in self.labels}


class TracerEquation2DCG(TracerEquation2D):
    """CG1 tracers with optional SUPG (ref ``tracer_eq_2d.py:448-501``,
    ``tracer_element_family='cg'`` + ``use_supg_tracer``).

    CG1 shares the P1 local basis with P1DG, so every term is inherited:
    the solution goes to cell-node layout, the DG projection gives the
    per-cell test contributions and a scatter-add over the cell -> vertex
    map assembles the continuous residual (interior facet fluxes cancel
    in the scatter; SIPG jump penalties vanish since CG traces agree).

    SUPG changes the test t -> t + tau u.grad(t) with tau = 0.5 h / U
    capped by Pe/3; for P1 the second derivatives vanish, so it acts on
    the cell accumulator only and the mass keeps the plain test
    (lumped-SUPG).  ``mass_inverse`` is a Jacobi-PCG on the consistent
    mass, 25 iterations, preconditioned by the lumped mass."""

    PCG_ITERATIONS = 25

    def __init__(self, mesh, asm, options, bathymetry, labels,
                 bnd_conditions=None, depth=None):
        super().__init__(mesh, asm, options, bathymetry, labels,
                         bnd_conditions=bnd_conditions, depth=depth)
        self.nv = mesh.nv
        self.cells = mesh.cells
        self.use_supg = bool(getattr(options, "use_supg_tracer", False))
        # cell-constant physical P1 test gradients (nc, 3, 2)
        dphi = np.asarray(asm.space._tab_np["dphi"])[0]
        self.gp1 = asm.as_tensor(
            np.einsum("dj,cji->cdi", dphi, np.asarray(mesh.Jinv_np)))
        # SUPG tau per cell: 0.5 h / U, capped by Pe/3
        U = float(getattr(options, "horizontal_velocity_scale", 0.1) or 0.1)
        D = float(getattr(options, "horizontal_diffusivity_scale", 0.0)
                  or 0.0)
        h = np.asarray(mesh.cell_hmin_np)
        tau = 0.5 * h / max(U, 1e-12)
        if D > 0:
            tau = np.minimum(tau, 0.5 * U * h / D / 3.0)
        self._tau = asm.as_tensor(tau)
        # lumped CG1 mass
        ml_cell = np.einsum("q,qd->d", np.asarray(asm.space._tab_np["qw"]),
                            np.asarray(asm.space._tab_np["phi"]))
        lumped = np.zeros(mesh.nv)
        np.add.at(lumped, np.asarray(mesh.cells_np).ravel(),
                  (ml_cell[None, :]
                   * np.asarray(mesh.detJ_np)[:, None]).ravel())
        self._lumped = asm.as_tensor(lumped)
        self._cells_flat = self.cells.reshape(-1)
        self._cg_mass_pcg = JacobiPCG(self._cg_mass_apply, self._lumped,
                                      self.PCG_ITERATIONS)

    # -- CG assembly helpers --------------------------------------------
    def _to_cells(self, sol):
        return {l: sol[l][self.cells] for l in self.labels}

    def _scatter(self, local):
        return local.new_zeros(self.nv).index_add(
            0, self._cells_flat, local.reshape(-1))

    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        asm = self.asm
        sol_c = self._to_cells(solution)
        c, B = self._buckets(sol_c, self._to_cells(solution_old), fields,
                             bnd_values, label)
        out = {}
        for l in self.labels:
            r = sol_c[l].new_zeros(self.mesh.nc, asm.ndofs)
            if B[l + "_cell"]:
                r = r + asm.cell_to_dofs(B[l + "_cell"].val)
            if self.use_supg and "uv_q" in c:
                # streamline stabilisation: the strong advective residual
                # -u.grad(c) tested against tau u.grad(t)
                uq = c["uv_q"]                             # (nc, nq, 2)
                strong = -(uq * asm.cell_grads(sol_c[l])).sum(-1)
                ug = torch.einsum("cqi,cdi->cqd", uq, self.gp1)
                r = r + self._tau[:, None] * torch.einsum(
                    "cq,cq,cqd->cd", strong, asm.wdetJ, ug)
            B[l + "_cell"] = Bucket()  # projected above
            out[l] = self._scatter(self._project(r, B, l))
        return out

    def _cg_mass_apply(self, v):
        return self._scatter(self.asm.mass_apply(v[self.cells]))

    def mass_term(self, solution):
        return {l: self._cg_mass_apply(solution[l]) for l in self.labels}

    def mass_inverse(self, r):
        return {l: self._cg_mass_pcg(r[l]) for l in self.labels}
