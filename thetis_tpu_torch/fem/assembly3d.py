r"""Matrix-free assembly on extruded prisms (P1DG x P1DG).

Port of ``thetis_tpu/fem/assembly3d.py``: fields live on dense
column-local tensors ``(nc, 3, nz, 2[, k])`` (cell, horizontal node,
layer, vertical node) and every operator is a contraction over the 2D
tabulations and the vertical P1 basis.

Geometry: the horizontal map is the 2D affine map; vertically
``z = (1-s) z_bot(x,y) + s z_top(x,y)`` with P1 interface surfaces, so

  detJ3 = detJ2 * Delta,         Delta = z_top - z_bot (layer thickness)
  d/dz  = (1/Delta) d/ds
  d/dx  = d/dx|_s - (dz/dx|_s / Delta) d/ds     (sigma-coordinate chain rule)

Quadrature-point convention: ``(nc, nz, nq, nqv[, k])`` for cells,
``(nf, 2, nz, nqf, nqv[, k])`` for vertical (inter-column) facets and
``(nc, nz+1, nq[, k])`` for horizontal (inter-layer) facets.

The reference unrolls every contraction into host-scalar multiply-adds
(the TPU pads tensors whose two minor axes are tiny onto (8, 128)
tiles); here each one is an einsum over the tabulations, with the same
outputs.  The quadratic tabulations (vertical P2 at the same Gauss
points, horizontal P2 at the same 2D quadrature points) serve the
quadratic baroclinic head of ``use_quadratic_pressure``.
"""
import numpy as np
import torch

__all__ = ["Assembler3D"]


def _mid(t, lead, extra):
    """Insert ``extra`` singleton axes after the first ``lead`` axes of
    ``t`` (broadcast a geometry factor against trailing component axes
    that sit before its own tail)."""
    return t.reshape(t.shape[:lead] + (1,) * extra + t.shape[lead:])


def _tail(t, extra):
    """Append ``extra`` singleton axes."""
    return t.reshape(t.shape + (1,) * extra)


def _inv3(A):
    """Closed-form inverse of (..., 3, 3) matrices (cofactors / det), the
    reference's formula."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    inv_det = 1.0 / (a * A11 + b * A21 + c * A31)
    rows = [torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1)]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


class Assembler3D:
    """Assembly context for the extruded P1DG x P1DG prism space."""

    def __init__(self, mesh2d, asm2d, extruded):
        self.mesh = mesh2d
        self.asm2d = asm2d
        self.ext = extruded
        self.nz = extruded.nz
        dev, dt = mesh2d.device, mesh2d.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        # vertical quadrature (degree 3) and P1 basis on [0, 1]
        t, wv = np.polynomial.legendre.leggauss(2)
        t = 0.5 * (t + 1)
        wv = 0.5 * wv
        self.qv_np, self.wv_np = t, wv
        self._psi_np = np.stack([1 - t, t], axis=1)          # (nqv, 2)
        self._dpsi_np = np.array([[-1.0, 1.0]] * len(t))     # (nqv, 2)
        self.qv = f(t)
        self.wv = f(wv)
        self.psi = f(self._psi_np)
        self.dpsi = f(self._dpsi_np)
        self.nq = len(asm2d.space._tab_np["qw"])
        self.nqf = len(asm2d.space._tab_np["qwf"])
        # vertical mass block and its inverse (host constants)
        self._Mv_np = np.einsum("v,vp,vr->pr", wv, self._psi_np,
                                self._psi_np)
        self.Mv = f(self._Mv_np)
        self.Mv_inv = f(np.linalg.inv(self._Mv_np))
        # (nc, nq, 3, 2) physical gradients of the horizontal basis
        self.gphi = torch.einsum("qdj,cji->cqdi", asm2d.space.dphi,
                                 mesh2d.Jinv)
        # quadratic vertical Lagrange basis at the nodes {0, 1/2, 1} at the
        # same 2-point Gauss rule: the int-PG integrand (quadratic head x
        # P1 test) is cubic in s, which degree-3 Gauss integrates exactly
        self._psi2_h = np.stack([2 * (t - 0.5) * (t - 1.0), 4 * t * (1 - t),
                                 2 * t * (t - 0.5)], axis=1)    # (nqv, 3)
        self._dpsi2_h = np.stack([4 * t - 3.0, 4.0 - 8 * t, 4 * t - 1.0],
                                 axis=1)                        # (nqv, 3)
        # P2 horizontal Lagrange basis at the same 2D quadrature points,
        # from the P1 one (its rows are the barycentric coordinates of the
        # points, its gradients theirs).  Node order: the 3 vertices, then
        # the edge midpoints opposite vertex 0, 1, 2 (m12, m02, m01)
        lam = np.asarray(asm2d.space._tab_np["phi"])           # (nq, 3)
        dlam = np.asarray(asm2d.space._tab_np["dphi"])         # (nq, 3, 2)
        phi2 = [lam[:, i] * (2 * lam[:, i] - 1) for i in range(3)]
        dphi2 = [dlam[:, i] * (4 * lam[:, i] - 1)[:, None] for i in range(3)]
        for j, k in ((1, 2), (0, 2), (0, 1)):
            phi2.append(4 * lam[:, j] * lam[:, k])
            dphi2.append(4 * (lam[:, j, None] * dlam[:, k]
                              + lam[:, k, None] * dlam[:, j]))
        self._phi2d_h = np.stack(phi2, axis=1)                 # (nq, 6)
        self._dphi2d_h = np.stack(dphi2, axis=1)               # (nq, 6, 2)
        #: ``cell_grads``' tabulation pairs of the quadratic head space
        self.p2_vtabs = (f(self._psi2_h), f(self._dpsi2_h))
        self.p2_htabs = (f(self._phi2d_h), f(self._dphi2d_h))

    # -- geometry --------------------------------------------------------
    def layer_geometry(self, z_interfaces):
        """Per-(cell, layer) geometry at horizontal quad points.

        :arg z_interfaces: (nc, 3, nz+1)
        :returns: dict with
           Delta_q   (nc, nz, nq)     layer thickness
           dzdx_q    (nc, nz, nq, nqv, 2)  horizontal gradient of z at
                                            each (s-)quad point
           Delta_nodes (nc, 3, nz)
           z_q (nc, nz+1, nq), gz_q (nc, nz+1, nq, 2), z_if (the input)
        """
        asm = self.asm2d
        zq = torch.einsum("qd,cdl->clq", asm.space.phi, z_interfaces)
        gz = asm.cell_grads(z_interfaces).movedim(2, 1)  # (nc, nz+1, nq, 2)
        gb, gt = gz[:, :-1], gz[:, 1:]
        s = self.qv[:, None]                             # (nqv, 1)
        dzdx = gb[:, :, :, None] * (1 - s) + gt[:, :, :, None] * s
        return dict(Delta_q=zq[:, 1:] - zq[:, :-1], dzdx_q=dzdx,
                    Delta_nodes=z_interfaces[..., 1:] - z_interfaces[..., :-1],
                    z_q=zq, gz_q=gz, z_if=z_interfaces)

    # -- evaluation ------------------------------------------------------
    def cell_values(self, u):
        """(nc, 3, nz, 2[, k]) -> (nc, nz, nq, nqv[, k])."""
        return torch.einsum("qd,vp,cdlp...->clqv...", self.asm2d.space.phi,
                            self.psi, u)

    def cell_grads(self, u, geom, vtabs=None, htabs=None):
        """Full physical gradient (nc, nz, nq, nqv[, k], 3) with components
        (d/dx, d/dy, d/dz) of (nc, nh, nz, npp[, k]) dofs.  ``vtabs =
        (psi, dpsi)`` selects the vertical basis (default P1, 2 nodes;
        ``self.p2_vtabs`` the quadratic one), ``htabs = (phi, dphi)`` with
        reference gradients the horizontal one (default P1DG;
        ``self.p2_htabs`` P2DG, 6 nodes)."""
        extra = u.ndim - 4
        psi, dpsi = (self.psi, self.dpsi) if vtabs is None else vtabs
        if htabs is None:
            phi, gphi = self.asm2d.space.phi, self.gphi
        else:
            phi = htabs[0]
            gphi = torch.einsum("qdj,cji->cqdi", htabs[1], self.mesh.Jinv)
        # horizontal derivative at fixed s, already physical
        gh = torch.einsum("cqdi,vp,cdlp...->clqv...i", gphi, psi, u)
        dds = torch.einsum("qd,vp,cdlp...->clqv...", phi, dpsi, u)
        dfdz = dds / _tail(geom["Delta_q"][..., None], extra)
        dzdx = _mid(geom["dzdx_q"], 4, extra)
        return torch.cat([gh - dfdz[..., None] * dzdx, dfdz[..., None]],
                         dim=-1)

    def interface_values(self, u):
        """Values at layer interfaces, horizontal quad points: returns
        ``(below, above)``, each (nc, nz+1, nq[, k]); at the bottom
        boundary 'below' duplicates 'above' and vice versa at the top."""
        phi = self.asm2d.space.phi
        top = torch.einsum("qd,cdl...->clq...", phi, u[:, :, :, 1])
        bot = torch.einsum("qd,cdl...->clq...", phi, u[:, :, :, 0])
        below = torch.cat([bot[:, :1], top], dim=1)
        above = torch.cat([bot, top[:, -1:]], dim=1)
        return below, above

    def facet_traces(self, u):
        """Vertical-facet traces: (nc,3,nz,2[,k]) -> (nf,2,nz,nqf,nqv[,k])."""
        cd = u[self.mesh.facet_cells]                # (nf, 2, 3, nz, 2, ...)
        return torch.einsum("fsqd,vp,fsdlp...->fslqv...",
                            self.asm2d.both_tabs, self.psi, cd)

    def _facet_geom(self, geom):
        """Both-side sigma-coordinate geometry at vertical-facet quad
        points: ``D_tr`` (nf, 2, nz, nqf) layer thickness and ``dzdx_f``
        (nf, 2, nz, nqf, nqv, 2)."""
        z_if = geom["z_if"][self.mesh.facet_cells]  # (nf, 2, 3, nz+1)
        D_tr = torch.einsum("fsqd,fsdl->fslq", self.asm2d.both_tabs,
                            z_if[..., 1:] - z_if[..., :-1])
        gz = torch.einsum("fsqdi,fsdl->fslqi", self.asm2d.both_gtabs_c, z_if)
        s = self.qv[:, None]
        dzdx_f = (gz[:, :, :-1, :, None] * (1 - s)
                  + gz[:, :, 1:, :, None] * s)
        return D_tr, dzdx_f

    def facet_trace_grads_h(self, u, geom):
        """Horizontal physical gradients of both-side traces at
        vertical-facet quad points (sigma-coordinate chain rule):
        (nc,3,nz,2[,k]) -> (nf,2,nz,nqf,nqv[,k],2)."""
        extra = u.ndim - 4
        D_tr, dzdx_f = self._facet_geom(geom)
        cd = u[self.mesh.facet_cells]
        gh = torch.einsum("fsqdi,vp,fsdlp...->fslqv...i",
                          self.asm2d.both_gtabs_c, self.psi, cd)
        dds = torch.einsum("fsqd,vp,fsdlp...->fslqv...",
                           self.asm2d.both_tabs, self.dpsi, cd)
        dfdz = dds / _tail(D_tr[..., None], extra)
        return gh - dfdz[..., None] * _mid(dzdx_f, 5, extra)

    # -- projection ------------------------------------------------------
    def wq(self, geom):
        """Combined cell quadrature weights (nc, nz, nq, nqv)."""
        w2 = self.asm2d.wdetJ[:, None, :]                 # (nc, 1, nq)
        return (w2 * geom["Delta_q"])[..., None] * self.wv

    def cell_to_dofs(self, acc, geom):
        """(nc, nz, nq, nqv[, k]) -> (nc, 3, nz, 2[, k])."""
        accw = acc * _tail(self.wq(geom), acc.ndim - 4)
        return torch.einsum("qd,vp,clqv...->cdlp...", self.asm2d.space.phi,
                            self.psi, accw)

    def grad_to_dofs(self, acc, geom):
        """(nc, nz, nq, nqv[, k], 3) tested against grad(test):
        ``d test/dx_i = dphi Jinv psi - phi (dz/dx / Delta) dpsi``,
        ``d test/dz = phi dpsi / Delta``."""
        extra = acc.ndim - 5
        w = _tail(self.wq(geom), extra)
        ah = acc[..., :2] * w[..., None]
        dzdx = _mid(geom["dzdx_q"], 4, extra)
        sig = (acc[..., :2] * dzdx).sum(-1)
        vz = (acc[..., 2] - sig) / _tail(geom["Delta_q"][..., None],
                                         extra) * w
        return (torch.einsum("cqdi,vp,clqv...i->cdlp...", self.gphi,
                             self.psi, ah)
                + torch.einsum("qd,vp,clqv...->cdlp...",
                               self.asm2d.space.phi, self.dpsi, vz))

    def _gather_facets(self, contrib):
        """Per-side facet contributions (nf, 2, 3, nz, 2, ...) -> cell
        dofs (nc, 3, nz, 2, ...) by gathering each cell's three facets."""
        mesh = self.mesh
        return contrib[mesh.cell_facets, mesh.cell_sides].sum(dim=1)

    def vfacet_to_dofs(self, acc, geom):
        """Vertical-facet accumulator (nf, 2, nz, nqf, nqv[, k]) tested
        against test traces -> (nc, 3, nz, 2[, k]).  Area element:
        facet length times the layer thickness traced on each side."""
        extra = acc.ndim - 5
        Dnf = geom["Delta_nodes"][self.mesh.facet_cells]   # (nf, 2, 3, nz)
        tabs = self.asm2d.both_tabs                        # (nf, 2, nqf, 3)
        D_tr = torch.einsum("fsqd,fsdl->fslq", tabs, Dnf)
        wbase = D_tr * self.asm2d.wlen[:, None, None, :]   # (nf, 2, nz, nqf)
        aw = acc * _tail(wbase[..., None] * self.wv, extra)
        contrib = torch.einsum("fsqd,vp,fslqv...->fsdlp...", tabs, self.psi,
                               aw)
        return self._gather_facets(contrib)

    def vfacet_grad_to_dofs(self, acc, geom):
        """Vertical-facet accumulator tested against the *horizontal
        gradient* of the test traces (sigma chain rule included):
        (nf, 2, nz, nqf, nqv[, k], 2) -> (nc, 3, nz, 2[, k])."""
        extra = acc.ndim - 6
        D_tr, dzdx_f = self._facet_geom(geom)
        wlen = self.asm2d.wlen[:, None, None, :]          # (nf, 1, 1, nqf)
        # horizontal part: weight = qwf * len * Delta * wv
        w1 = _tail((wlen * D_tr)[..., None] * self.wv, extra)
        t1 = torch.einsum("fsqdi,vp,fslqv...i->fsdlp...",
                          self.asm2d.both_gtabs_c, self.psi,
                          acc * w1[..., None])
        # sigma correction: weight = qwf * len * wv (Delta cancels)
        corr = (acc * _mid(dzdx_f, 5, extra)).sum(-1)
        w2 = _tail(wlen[..., None] * self.wv, extra)
        t2 = torch.einsum("fsqd,vp,fslqv...->fsdlp...",
                          self.asm2d.both_tabs, self.dpsi, corr * w2)
        return self._gather_facets(t1 - t2)

    def hfacet_to_dofs(self, acc_below, acc_above, geom):
        """Horizontal-facet (layer-interface) accumulators tested against
        the test traces from below/above: each (nc, nz+1, nq[, k])
        -> (nc, 3, nz, 2[, k]).  Area element: horizontal detJ2 * qw."""
        extra = acc_below.ndim - 3
        w = _tail(self.asm2d.wdetJ[:, None, :], extra)    # (nc, 1, nq, ..)
        phi = self.asm2d.space.phi
        # below-trace at interfaces 1..nz = tops of layers 0..nz-1;
        # above-trace at interfaces 0..nz-1 = bottoms
        bot = torch.einsum("qd,clq...->cdl...", phi, acc_above[:, :-1] * w)
        top = torch.einsum("qd,clq...->cdl...", phi, acc_below[:, 1:] * w)
        return torch.stack([bot, top], dim=3)

    # -- mass ------------------------------------------------------------
    def _mass_h(self, geom):
        """Horizontal factor of the prism mass matrix, (nc, nz, 3, 3): the
        exact Kronecker form ``M = Mh(c, l) (x) Mv``."""
        phi = self.asm2d.space.phi
        w = self.asm2d.wdetJ[:, None, :] * geom["Delta_q"]  # (nc, nz, nq)
        return torch.einsum("clq,qa,qb->clab", w, phi, phi)

    @staticmethod
    def _kron_apply(Mh, Mv, u):
        """Apply ``(Mh (x) Mv)`` to u, axes (c, node, layer, vnode[, k])."""
        return torch.einsum("clab,pr,cblr...->calp...", Mh, Mv, u)

    def mass_apply(self, u, geom):
        return self._kron_apply(self._mass_h(geom), self.Mv, u)

    def mass_inverse(self, r, geom):
        return self._kron_apply(_inv3(self._mass_h(geom)), self.Mv_inv, r)

    # -- vertical operators ----------------------------------------------
    def vertical_integral(self, u, geom, average=False):
        """Column integral (or average) of a 3D field -> 2D nodal tensor
        (nc, 3[, k]) (exact for P1 vertical)."""
        Dn = geom["Delta_nodes"]                            # (nc, 3, nz)
        extra = u.ndim - 4
        layer_int = 0.5 * (u[:, :, :, 0] + u[:, :, :, 1]) * _tail(Dn, extra)
        total = layer_int.sum(dim=2)
        if average:
            return total / _tail(Dn.sum(dim=2), extra)
        return total

    def cumulative_integral(self, u, geom, from_top=True):
        """Cumulative integral along the column at layer dof points
        (nc, 3, nz, 2[, k])."""
        Dn = geom["Delta_nodes"]
        extra = u.ndim - 4
        layer_int = 0.5 * (u[:, :, :, 0] + u[:, :, :, 1]) * _tail(Dn, extra)
        if from_top:
            csum = torch.flip(torch.cumsum(torch.flip(layer_int, [2]), 2),
                              [2])
            at_top = csum - layer_int
            at_bot = csum
        else:
            csum = torch.cumsum(layer_int, 2)
            at_bot = csum - layer_int
            at_top = csum
        return torch.stack([at_bot, at_top], dim=3)
