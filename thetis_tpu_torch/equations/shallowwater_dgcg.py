r"""dg-cg element family for the 2D shallow-water equations (port of
``thetis_tpu/equations/shallowwater_dgcg.py``).

The reference's ``element_family = 'dg-cg'`` (``solver2d.py:307-352``):
P1DG velocity paired with **P2 CG elevation**.  All momentum-row terms are
inherited unchanged from :class:`ShallowWaterEquations`; only the
elevation-space machinery differs:

* context: ``eta_q``/``eta_tr`` evaluated from CG2 dofs (single-valued
  traces, each side evaluated from its own cell),
* projection: elevation-row buckets are tested against the continuous P2
  basis and scatter-added (``index_add``) into the shared CG dofs.
  Interior facet fluxes are written antisymmetrically by the terms ([-f,
  +f] per side), so they cancel in the scatter: exactly on the CPU, to
  roundoff on the card, where the scatter's atomics add in no fixed
  order,
* mass: the consistent CG2 mass applied cell-wise and scattered, inverted
  by 30 Jacobi-preconditioned CG iterations
  (:class:`~thetis_tpu_torch.solvers.pcg.JacobiPCG`).  The reference
  preconditions with the lumped mass (``shallowwater_dgcg.py:56-60``),
  whose vertex entries are roundoff (a P2 vertex basis function
  integrates to 0 on a triangle): its iterates start near ``r / 1e-10``,
  end O(1) off the inverse in f64 and overflow to NaN in f32.  Here the
  preconditioner is the consistent mass's diagonal, with which the 30
  iterations converge (ROADMAP C).  The implicit steppers, which use the
  inverse as a preconditioner, reach the same solution as the
  reference's.

Wetting-and-drying requires the DG elevation space and is rejected, as
in the reference.
"""
import numpy as np
import torch

from ..fem.reference_element import P2Tri, triangle_quadrature
from ..solvers.pcg import JacobiPCG
from .base import Bucket, facet_quad_value_2s
from .shallowwater_2d import ShallowWaterEquations, swe_state

__all__ = ["ShallowWaterEquationsDGCG"]


class ShallowWaterEquationsDGCG(ShallowWaterEquations):
    #: PCG iterations of the CG2 mass inverse (the reference's count)
    PCG_ITERATIONS = 30

    def __init__(self, mesh, asm, cg2_space, options, bathymetry,
                 bnd_conditions=None, tidal_farms=None):
        if getattr(options, "use_wetting_and_drying", False):
            raise ValueError(
                "wetting-and-drying requires the dg-dg element family")
        super().__init__(mesh, asm, options, bathymetry=bathymetry,
                         bnd_conditions=bnd_conditions,
                         tidal_farms=tidal_farms)
        self.eta_space = cg2_space
        self.cnm = cg2_space.cell_node_map               # (nc, 6)
        self.n_eta = cg2_space.node_count
        f = asm.as_tensor

        # cross-tabulations of the P2 basis at the P1DG assembler's
        # cell/facet quadrature points (host, mesh-static)
        qp = np.asarray(asm.space._tab_np["qp"])
        ts = np.asarray(asm.space._tab_np["qt"])
        self.phi2q = f(P2Tri.eval_basis(qp))             # (nq, 6)
        self.gphi2q = f(np.einsum("qdj,cji->cqdi", P2Tri.eval_grad(qp),
                                  mesh.Jinv_np))         # (nc, nq, 6, 2)
        fpts = P2Tri.facet_points(ts)                    # (6, nqf, 2)
        phi2f = np.stack([P2Tri.eval_basis(fpts[v]) for v in range(6)])
        self.tr_tabs = f(phi2f[mesh.facet_variant_np])   # (nf, 2, nqf, 6)
        cnm_np = np.asarray(cg2_space.cell_node_map_np, dtype=np.int64)
        self.fcell_nodes = torch.as_tensor(cnm_np[mesh.facet_cells_np],
                                           device=mesh.device)  # (nf, 2, 6)
        # one scatter of the cell and facet-side contributions together
        self._scatter_index = torch.cat([self.cnm.reshape(-1),
                                         self.fcell_nodes.reshape(-1)])

        # consistent reference P2 mass (exact: degree-4 quadrature) and
        # the global mass's diagonal for preconditioning
        qp4, qw4 = triangle_quadrature(4)
        phi4 = P2Tri.eval_basis(np.asarray(qp4))
        Mref2 = np.einsum("q,qd,qe->de", np.asarray(qw4), phi4, phi4)
        self.Mref2 = f(Mref2)
        self._detJ_col = mesh.detJ[:, None]
        diag = np.zeros(cg2_space.node_count)
        np.add.at(diag, cnm_np.ravel(),
                  (np.diag(Mref2)[None, :] * mesh.detJ_np[:, None]).ravel())
        self.mass_diag = f(diag)
        self._eta_pcg = JacobiPCG(self.eta_mass_apply, self.mass_diag,
                                  self.PCG_ITERATIONS)

    # ---------------- CG2 elevation operators -------------------------
    def eta_cell_values(self, eta):
        return torch.einsum("qd,cd->cq", self.phi2q, eta[self.cnm])

    def eta_traces(self, eta):
        """Single-valued facet traces on both sides (nf, 2, nqf), each
        side evaluated from its own cell (equal up to roundoff; keeping
        per-side evaluation keeps the antisymmetric cancellation of the
        interior fluxes)."""
        E = eta[self.fcell_nodes]                          # (nf, 2, 6)
        return (self.tr_tabs * E[:, :, None, :]).sum(-1)

    def eta_cell_grads(self, eta):
        """The CG2 elevation's gradient at the cell quad points
        (nc, nq, 2)."""
        return (self.gphi2q * eta[self.cnm][:, None, :, None]).sum(2)

    def _eta_scatter(self, local_cells=None, local_facets=None):
        """Accumulate per-cell (nc, 6) and per-facet-side (nf, 2, 6)
        contributions into the global CG dof vector."""
        if local_facets is None:
            src, index = local_cells.reshape(-1), self.cnm.reshape(-1)
        elif local_cells is None:
            src = local_facets.reshape(-1)
            index = self.fcell_nodes.reshape(-1)
        else:
            src = torch.cat([local_cells.reshape(-1),
                             local_facets.reshape(-1)])
            index = self._scatter_index
        return src.new_zeros(self.n_eta).index_add(0, index, src)

    def project_eta_buckets(self, B_cell, B_grad, B_facet):
        """CG projection of the elevation-row accumulators."""
        asm = self.asm
        lc = None
        if B_cell is not None:
            lc = torch.einsum("cq,qd->cd", B_cell * asm.wdetJ, self.phi2q)
        if B_grad is not None:
            wg = B_grad * asm.wdetJ[..., None]                # (nc, nq, 2)
            lg = (wg[:, :, None, :] * self.gphi2q).sum((1, 3))
            lc = lg if lc is None else lc + lg
        lf = None
        if B_facet is not None:
            wf = B_facet * asm.wlen[:, None, :]               # (nf, 2, nqf)
            lf = (wf[..., None] * self.tr_tabs).sum(2)
        if lc is None and lf is None:
            return self.mass_diag.new_zeros(self.n_eta)
        return self._eta_scatter(lc, lf)

    def eta_mass_apply(self, eta):
        # one (nc, 6) x (6, 6) product: the reference matrix is symmetric
        # and shared by every cell (a broadcast sum over the last axis of
        # 6 is ~2x slower on the card; ``einsum``'s dispatch doubles the
        # call's host time on the CPU)
        local = torch.mm(eta[self.cnm], self.Mref2).mul_(self._detJ_col)
        return self._eta_scatter(local_cells=local)

    def mass_inverse_elev(self, r):
        """The consistent CG2 mass inverse: Jacobi PCG, 30 iterations."""
        return self._eta_pcg(r)

    def norm_elev(self, eta):
        """L2 norm of a CG2 elevation field."""
        return torch.sqrt(torch.clamp_min(
            (eta * self.eta_mass_apply(eta)).sum(), 0.0))

    # ---------------- context / residual / mass ------------------------
    def build_context(self, solution, solution_old, fields, bnd_values):
        asm = self.asm
        uv, eta = solution["uv"], solution["elev"]
        uv_old, eta_old = solution_old["uv"], solution_old["elev"]
        bdyn = fields.get("bathymetry_2d")
        if bdyn is not None:
            c = {"bathy_q": self._any_cell_q(bdyn),
                 "bathy_grad_q": self._any_cell_grad(bdyn),
                 "bathy_tr": facet_quad_value_2s(asm, bdyn)}
        else:
            c = {"bathy_q": self.bathy_q, "bathy_grad_q": self.bathy_grad_q,
                 "bathy_tr": self.bathy_tr}
        packed = torch.cat([uv, uv_old], dim=-1)          # (nc, nd, 4)
        pq = asm.cell_values(packed)
        c["uv_q"] = pq[..., 0:2]
        c["uv_old_q"] = pq[..., 2:4]
        petr = asm.facet_traces(packed)
        c["uv_tr"] = petr[..., 0:2]
        c["uv_old_tr"] = petr[..., 2:4]
        c["eta_q"] = self.eta_cell_values(eta)
        c["eta_old_q"] = self.eta_cell_values(eta_old)
        # CG2 elevation gradient at cell quad points (direct-form epg)
        c["eta_grad_q"] = self.eta_cell_grads(eta)
        c["eta_tr"] = self.eta_traces(eta)
        c["eta_old_tr"] = self.eta_traces(eta_old)
        c["H_q"] = self.depth.total_depth(c["bathy_q"], c["eta_old_q"],
                                          self.alpha_q)
        c["H_tr"] = self.depth.total_depth(c["bathy_tr"], c["eta_old_tr"],
                                           self.alpha_tr)
        c["n"] = self.mesh.facet_normal[:, None, :]
        c["eta_ext"], c["uv_ext"] = self._bnd_ext(
            c["eta_tr"][:, 0], c["uv_tr"][:, 0], bnd_values,
            c["bathy_tr"][:, 0])
        c["eta_ext_old"], c["uv_ext_old"] = self._bnd_ext(
            c["eta_old_tr"][:, 0], c["uv_old_tr"][:, 0], bnd_values,
            c["bathy_tr"][:, 0])
        c["fields"] = fields
        c["bnd_values"] = bnd_values
        return c

    def _t_epg(self, c, B):
        """CG elevation: direct-gradient form (ref ``shallowwater_eq.py:
        384-393``, the ``eta_is_dg=False`` branch): no interior facet
        terms, so the velocity block of the wave system stays a pure DG
        mass matrix.  Open boundaries get the linear Riemann correction
        ``g (eta_rie - eta) psi.n``."""
        g = self.g
        B["uv_cell"].add(-g * c["eta_grad_q"])
        n = c["n"]
        eta_b = c["eta_tr"][:, 0]
        uv_b = c["uv_tr"][:, 0]
        H_b = c["H_tr"][:, 0]
        srt = torch.sqrt(torch.abs(H_b) / g)
        un_jump = ((uv_b - c["uv_ext"]) * n).sum(-1)
        eta_rie = 0.5 * (eta_b + c["eta_ext"]) + srt * un_jump
        contrib = (-g * (eta_rie - eta_b)[..., None] * n
                   * self._mask_q(self.mask_open, 1))
        B["uv_facet"].add(
            torch.stack([contrib, torch.zeros_like(contrib)], dim=1))

    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        c = self.build_context(solution, solution_old, fields, bnd_values)
        c["_uv_dofs"] = solution["uv"]
        c["_uv_old_dofs"] = solution_old["uv"]
        # CG2 elevation gradient at cell quad points (grad-depth viscosity)
        c["eta_old_grad_q"] = self.eta_cell_grads(solution_old["elev"])
        B = {k: Bucket() for k in
             ("uv_cell", "uv_grad", "uv_facet", "uv_fgrad",
              "eta_cell", "eta_grad", "eta_facet")}
        for _, method in self.select_terms(label):
            method(c, B)
        asm = self.asm
        # momentum rows: the DG projection
        r_uv = torch.zeros_like(solution["uv"])
        if B["uv_cell"]:
            r_uv = r_uv + asm.cell_to_dofs(B["uv_cell"].val)
        if B["uv_grad"]:
            r_uv = r_uv + asm.grad_to_dofs(B["uv_grad"].val)
        if B["uv_facet"] and B["uv_fgrad"]:
            r_uv = r_uv + asm.facet_fgrad_to_dofs(B["uv_facet"].val,
                                                  B["uv_fgrad"].val)
        elif B["uv_facet"]:
            r_uv = r_uv + asm.facet_to_dofs(B["uv_facet"].val)
        elif B["uv_fgrad"]:
            r_uv = r_uv + asm.fgrad_to_dofs(B["uv_fgrad"].val)
        # elevation rows: the CG projection (interior fluxes cancel in
        # the scatter)
        r_eta = self.project_eta_buckets(B["eta_cell"].val,
                                         B["eta_grad"].val,
                                         B["eta_facet"].val)
        return swe_state(r_uv, r_eta)

    def mass_term(self, solution):
        return swe_state(self.asm.mass_apply(solution["uv"]),
                         self.eta_mass_apply(solution["elev"]))
