"""Matrix-free DG assembly primitives.

Port of ``thetis_tpu/fem/assembly.py``: every weak-form integral is
evaluated as batched tensor contractions over the mesh's static cell and
facet tables, in three stages (evaluate at quadrature points, let the
terms accumulate their integrands, project onto test functions by
gathering facet contributions per cell: no scatter-add).

Accumulator conventions (R = d(u)/dt weak residual, reference sign):
  acc_cell  (nc, nq[, k])       tested against   test value
  acc_grad  (nc, nq[, k], 2)    tested against   d(test)/dx_i
  acc_facet (nf, 2, nqf[, k])   tested against   per-side test trace
  acc_fgrad (nf, 2, nqf[, k], 2) tested against  per-side trace of grad(test)

All methods are functional (no in-place updates), so they compose with
``torch.func.jvp``/``vmap`` in the block assembly.
"""
import numpy as np
import torch

from .reference_element import P1Tri

__all__ = ["DGAssembler", "coefficient_cell_q"]


def _is_scalar_like(val, tail):
    return np.isscalar(val) or (hasattr(val, "ndim") and val.ndim == len(tail))


def coefficient_cell_q(asm, val, vector=False):
    """Evaluate a coefficient at cell quadrature points: accepts python
    scalars, 0-d tensors, CG1 vertex arrays (nv,), DG dof arrays (nc, nd),
    P0 arrays (nc, 1) or ready (nc, nq) arrays (+ trailing component axis
    for vectors)."""
    mesh = asm.mesh
    tail = (2,) if vector else ()
    nq = len(asm.space._tab_np["qw"])
    if val is None:
        return None
    if _is_scalar_like(val, tail):
        return asm.as_tensor(val).expand((mesh.nc, nq) + tail)
    val = asm.as_tensor(val)
    if val.shape[:1] == (mesh.nv,):
        return asm.cg1_values(val[mesh.cells])
    if val.shape[:2] == (mesh.nc, asm.ndofs):
        return asm.cell_values(val)
    if val.shape[:2] == (mesh.nc, 1):  # P0
        return val[:, :1].expand((mesh.nc, nq) + tail)
    if val.shape[:2] == (mesh.nc, nq):
        return val
    raise ValueError(f"cannot evaluate coefficient of shape {tuple(val.shape)}")


def _wexpand(w, acc, ndim_head):
    """Reshape weight tensor w to broadcast against acc beyond ndim_head
    axes."""
    extra = acc.ndim - ndim_head
    return w.reshape(w.shape + (1,) * extra)


class DGAssembler:
    """Assembly context for one (mesh, element, quadrature) combination.
    The tables captured at construction are static tensors on the mesh's
    device."""

    def __init__(self, mesh, space):
        self.mesh = mesh
        self.space = space
        el = space.element
        self.ndofs = el.ndofs
        dev, dt = mesh.device, mesh.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        # host-side exact reference mass matrix and inverse
        tab = space._tab_np
        Mref = np.einsum("q,qd,qe->de", tab["qw"], tab["phi"], tab["phi"])
        self._Mref_np = Mref
        self._Mref_inv_np = np.linalg.inv(Mref)
        self.Mref = f(Mref)
        self.Mref_inv = f(self._Mref_inv_np)
        # flat (nc, 3) index into (nf*2, ...) per-side facet contributions
        self.cell_facet_flat = torch.as_tensor(
            mesh.cell_facets_np.astype(np.int64) * 2 + mesh.cell_sides_np,
            device=dev)
        fv_np = mesh.facet_variant_np
        fc_np = mesh.facet_cells_np
        phi_f_np = np.asarray(tab["phi_f"])
        dphi_f_np = np.asarray(tab["dphi_f"])
        self.both_tabs = f(phi_f_np[fv_np])  # (nf,2,nqf,nd)
        gt_np = np.einsum(
            "fsqdj,fsji->fsqdi", dphi_f_np[fv_np], mesh.Jinv_np[fc_np]
        )
        self.both_gtabs_c = f(gt_np)  # (nf,2,nqf,nd,2)
        # weight-folded flat projection tables (nf*2, nqf, nd[, 2])
        wlen_np = (np.asarray(tab["qwf"])[None, :]
                   * mesh.facet_len_np[:, None])  # (nf, nqf)
        nfl = fv_np.shape[0]
        self.wtabs_flat = f(
            (phi_f_np[fv_np] * wlen_np[:, None, :, None]).reshape(
                nfl * 2, -1, el.ndofs))
        self.wgtabs_flat = f(
            (gt_np * wlen_np[:, None, :, None, None]).reshape(
                nfl * 2, -1, el.ndofs, 2))
        # CG1 coefficient tabulations at this space's quadrature points
        self.phi_cg1 = f(P1Tri.eval_basis(np.asarray(tab["qp"])))
        self.dphi_cg1 = f(P1Tri.eval_grad(np.asarray(tab["qp"])))
        self.wdetJ = space.qw[None, :] * mesh.detJ[:, None]     # (nc, nq)
        self.wlen = space.qwf[None, :] * mesh.facet_len[:, None]  # (nf, nqf)

    def as_tensor(self, val):
        """A coefficient value as a tensor on the mesh's device/dtype."""
        return torch.as_tensor(val, dtype=self.mesh.dtype,
                               device=self.mesh.device)

    def _dofs(self, u):
        """Dof data as given (a tensor), or host data, as the reference
        takes it, as a tensor on the mesh's device and dtype."""
        return u if isinstance(u, torch.Tensor) else self.as_tensor(u)

    # ======================= evaluation ================================
    def cell_values(self, u):
        """(nc, nd[, k]) dofs -> (nc, nq[, k]) quad-point values."""
        return torch.einsum("qd,cd...->cq...", self.space.phi, self._dofs(u))

    def cell_grads(self, u):
        """(nc, nd[, k]) -> (nc, nq[, k], 2) physical gradients."""
        g = torch.einsum("qdj,cd...->cq...j", self.space.dphi, self._dofs(u))
        return torch.einsum("cq...j,cji->cq...i", g, self.mesh.Jinv)

    def cg1_values(self, u):
        """CG1 cell-vertex data (nc, 3[, k]) -> (nc, nq[, k])."""
        return torch.einsum("qd,cd...->cq...", self.phi_cg1, u)

    def cg1_grads(self, u):
        """CG1 cell-vertex data (nc, 3[, k]) -> (nc, nq[, k], 2)."""
        g = torch.einsum("qdj,cd...->cq...j", self.dphi_cg1, u)
        return torch.einsum("cq...j,cji->cq...i", g, self.mesh.Jinv)

    def both_gtabs(self):
        """Physical facet basis gradients, both sides: (nf, 2, nqf, nd, 2)."""
        return self.both_gtabs_c

    def _gather_sides(self, u):
        """Gather both-side cell dofs: (nc, nd[, k]) -> (nf, 2, nd[, k])."""
        return u[self.mesh.facet_cells]

    def facet_traces(self, u):
        """(nc, nd[, k]) -> (nf, 2, nqf[, k]) both-side traces."""
        return torch.einsum("fsqd,fsd...->fsq...", self.both_tabs,
                            self._gather_sides(u))

    def facet_trace_grads(self, u):
        """(nc, nd[, k]) -> (nf, 2, nqf[, k], 2)."""
        return torch.einsum("fsqdi,fsd...->fsq...i", self.both_gtabs_c,
                            self._gather_sides(u))

    def facet_midpoint_data(self, vertex_field):
        """A P1CG (per-vertex) coefficient at the facet quad points:
        (nv,) -> (nf, nqf), linear along the facet."""
        v = self._dofs(vertex_field)
        fv = self.mesh.facet_verts
        a, b = v[fv[:, 0]], v[fv[:, 1]]
        return a[:, None] + (b - a)[:, None] * self.space.tab("qt")[None, :]

    # ======================= projection ================================
    def cell_to_dofs(self, acc):
        """(nc, nq[, k]) -> (nc, nd[, k])."""
        accw = acc * _wexpand(self.wdetJ, acc, 2)
        return torch.einsum("cq...,qd->cd...", accw, self.space.phi)

    def grad_to_dofs(self, acc):
        """(nc, nq[, k], 2) -> (nc, nd[, k])."""
        accw = acc * _wexpand(self.wdetJ[..., None], acc, 3)
        # d(test_d)/dx_i = dphi[q,d,j] Jinv[c,j,i]
        gphi = torch.einsum("qdj,cji->cqdi", self.space.dphi, self.mesh.Jinv)
        return torch.einsum("cq...i,cqdi->cd...", accw, gphi)

    def _facet_contrib_flat(self, acc):
        """(nf, 2, nqf[, k...]) -> ((nf*2, nd*k) weighted per-side test
        contributions, tail shape)."""
        nqf = acc.shape[2]
        a2 = acc.reshape(acc.shape[0] * 2, nqf, -1)  # (nf*2, nqf, k)
        c = torch.einsum("fqk,fqd->fdk", a2, self.wtabs_flat)
        return c.reshape(c.shape[0], -1), acc.shape[3:]

    def facet_to_dofs(self, acc):
        """(nf, 2, nqf[, k]) -> (nc, nd[, k])."""
        flat, tail = self._facet_contrib_flat(acc)
        g = flat[self.cell_facet_flat].sum(dim=1)  # (nc, nd*k)
        return g.reshape((g.shape[0], self.ndofs) + tuple(tail))

    def _fgrad_contrib_flat(self, acc):
        """(nf, 2, nqf[, k], 2) -> ((nf*2, nd*k) contributions, tail)."""
        nqf = acc.shape[2]
        tail = acc.shape[3:-1]
        a2 = acc.reshape((acc.shape[0] * 2, nqf, -1, 2))  # (nf*2,nqf,k,2)
        c = torch.einsum("fqki,fqdi->fdk", a2, self.wgtabs_flat)
        return c.reshape(c.shape[0], -1), tail

    def fgrad_to_dofs(self, acc):
        """(nf, 2, nqf[, k], 2) -> (nc, nd[, k])."""
        flat, tail = self._fgrad_contrib_flat(acc)
        g = flat[self.cell_facet_flat].sum(dim=1)
        return g.reshape((g.shape[0], self.ndofs) + tuple(tail))

    def facet_fgrad_to_dofs(self, acc_facet, acc_fgrad):
        """Combined facet + facet-gradient projection sharing ONE cell
        gather: acc_facet (nf,2,nqf[,k]), acc_fgrad (nf,2,nqf[,kg],2) with
        kg <= k (missing trailing components padded with zeros)."""
        flat_f, tail = self._facet_contrib_flat(acc_facet)
        flat_g, _ = self._fgrad_contrib_flat(acc_fgrad)
        if flat_g.shape[1] != flat_f.shape[1]:
            # flat layout is (nd, k) row-major: pad each dof block's
            # component axis up to the facet accumulator's k
            kf = flat_f.shape[1] // self.ndofs
            kg = flat_g.shape[1] // self.ndofs
            fg = flat_g.reshape(-1, self.ndofs, kg)
            fg = torch.nn.functional.pad(fg, (0, kf - kg))
            flat_g = fg.reshape(-1, self.ndofs * kf)
        g = (flat_f + flat_g)[self.cell_facet_flat].sum(dim=1)
        return g.reshape((g.shape[0], self.ndofs) + tuple(tail))

    # ======================= mass operators ============================
    def mass_apply(self, u):
        """Block-diagonal DG mass matrix action (exact for affine cells)."""
        return torch.einsum("de,ce...->cd...", self.Mref, u) * _wexpand(
            self.mesh.detJ[:, None], u, 2)

    def mass_inverse(self, r):
        """Exact inverse mass action (closed-form per-cell block
        inverse)."""
        return torch.einsum("de,ce...->cd...", self.Mref_inv, r) / _wexpand(
            self.mesh.detJ[:, None], r, 2)

    def project_rhs(self, fq):
        """L2-project quad-point values (nc, nq[, k]) onto DG dofs."""
        return self.mass_inverse(self.cell_to_dofs(fq))

    # ======================= integrals =================================
    def integrate_cellq(self, fq):
        """Integrate quad-point values (nc, nq[, k]) over the domain."""
        return torch.einsum("cq...,cq->...", fq, self.wdetJ)

    def integrate(self, u):
        return self.integrate_cellq(self.cell_values(u))

    def norm_l2(self, u):
        """L2 norm of a scalar (nc, nd) or vector (nc, nd, 2) field."""
        v = self.cell_values(u)
        v2 = (v ** 2).sum(-1) if v.dim() == 3 else v ** 2
        return torch.sqrt(torch.einsum("cq,cq->", v2, self.wdetJ))
