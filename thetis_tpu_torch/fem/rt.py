r"""Lowest-order Raviart-Thomas space RT1 on triangles (port of
``thetis_tpu/fem/rt.py``).

H(div) element of the mimetic ``rt-dg`` shallow-water pair (ref
``solver2d.py:307-336``: velocity in RT, elevation in DG; this is the
lowest-order member RT1 x P0).

Degrees of freedom are the facet normal velocities: one dof per mesh
facet, shared between the two adjacent cells so the normal component is
continuous (the H(div) conformity).  The basis function of cell ``c``
attached to its local facet ``i`` (opposite local vertex ``i``) is, in
physical coordinates,

    psi_i(x) = sigma * |e_i| / (2 A_c) * (x - p_i),

with sigma = +1 when the cell is the facet's side-0 owner and -1
otherwise, so that ``psi_i . n_f = 1`` along the facet's global normal
from both sides and ``psi_i . n_j = 0`` on the other two facets.  Its
divergence is the cell constant ``sigma |e_i| / A_c`` and its gradient
``sigma |e_i| / (2 A_c) I``.

The tabulations are built on the host in float64 numpy (mesh-static) and
kept on the mesh's device in its dtype; evaluation is gathers and
contractions, projection a scatter-add (``index_add``) onto the facet
dofs.  A contraction that keeps a cell (or facet) index on both operands
is written as a broadcast product and a sum: as an ``einsum`` it becomes
a batched matrix product of one tiny matrix a cell, ~0.5 ms a call at
10^5 cells on the card against a memory-bound pass.  The formulas carry
a generic trailing coordinate dimension: 2 on planar meshes, 3 on a
:class:`~thetis_tpu_torch.mesh.sphere.SphereMesh` (each flat cell's own
plane).
"""
import numpy as np
import torch

from ..solvers.pcg import JacobiPCG
from .reference_element import ReferenceElement

__all__ = ["HdivSpace", "RTSpace", "hdiv_jacobian", "scatter_add"]


def hdiv_jacobian(mesh):
    """(nc, gdim, 2) cell Jacobians ``[p1 - p0, p2 - p0]`` (seam-aware on
    periodic meshes)."""
    coords, cells = mesh.coords_np, mesh.cells_np
    p0 = coords[cells[:, 0]]
    d1 = coords[cells[:, 1]] - p0
    d2 = coords[cells[:, 2]] - p0
    if (getattr(mesh, "periodic_x_len", None) is not None
            or getattr(mesh, "periodic_y_len", None) is not None):
        d1 = mesh._wrap_dx(d1)
        d2 = mesh._wrap_dx(d2)
    return np.stack([d1, d2], axis=2)


def scatter_add(n, index, src):
    """``zeros(n).at[index].add(src)`` of the reference, flat."""
    return src.new_zeros(n).index_add(0, index.reshape(-1), src.reshape(-1))


class HdivSpace:
    """The evaluation, projection and mass that the H(div) spaces share.

    A space sets, through :meth:`_set_tables`, a flat local-to-global dof
    index ``dofmap`` (nc, k) over dofs of shape ``dof_shape()``, its
    basis at the cell quadrature points ``psi_q`` (nc, k, nq, gdim) and
    at the facet quadrature points from each side ``psi_tr`` (nf, 2, nqf,
    k, gdim); the cell mass blocks ``Mloc`` (nc, k, k), their assembled
    diagonal ``mass_diag`` and the mass inverse follow from these."""

    dim = 2
    is_dg = False
    PCG_ITERATIONS = None

    def _set_tables(self, dofmap, psi_q, psi_tr, shape):
        """Put the tables on the mesh's device in its dtype; ``psi_q`` and
        ``psi_tr`` are float64 numpy, ``shape`` the dof shape."""
        mesh = self.mesh
        tab = self.asm.space._tab_np
        w = np.asarray(tab["qw"])
        detJ = mesh.detJ_np
        self._shape = tuple(shape)
        self.ndofs = self.node_count = int(np.prod(shape))
        self.psi_q_np, self.psi_tr_np = psi_q, psi_tr
        self.wdetJ_np = w[None, :] * detJ[:, None]
        # M_jk = sum_q w detJ psi_j . psi_k
        Mloc = np.einsum("q,c,cjqi,ckqi->cjk", w, detJ, psi_q, psi_q)
        self.Mloc_np = Mloc
        diag = np.zeros(self.ndofs)
        np.add.at(diag, dofmap.ravel(), np.einsum("cjj->cj", Mloc).ravel())

        dev, dt = mesh.device, mesh.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        self.dofmap = torch.as_tensor(dofmap.astype(np.int64), device=dev)
        # facet -> the (2 sides x k) dofs its side cells test
        self._facet_targets = self.dofmap[mesh.facet_cells]
        self.psi_q = f(psi_q)
        self.psi_tr = f(psi_tr)
        self.Mloc = f(Mloc)
        self.mass_diag = f(np.maximum(diag, np.finfo(diag.dtype).tiny)
                           .reshape(shape))
        self._mass_pcg = JacobiPCG(self.mass_apply, self.mass_diag,
                                   self.PCG_ITERATIONS)
        self.wdetJ = f(self.wdetJ_np)                               # (nc, nq)
        self.wlen = f(np.asarray(tab["qwf"])[None, :]
                      * mesh.facet_len_np[:, None])                 # (nf, nqf)

    # -- Function compatibility -------------------------------------------
    def zero_dofs(self):
        return torch.zeros(self._shape, dtype=self.mesh.dtype,
                           device=self.mesh.device)

    def dof_shape(self):
        return self._shape

    # -- evaluation ------------------------------------------------------
    def _cell_dofs(self, U):
        """Dofs -> (nc, k) local dof values."""
        return U.reshape(-1)[self.dofmap]

    def cell_values(self, U):
        """Dofs -> velocity at cell quad points (nc, nq, gdim)."""
        return (self._cell_dofs(U)[:, :, None, None] * self.psi_q).sum(1)

    def facet_traces(self, U):
        """Full velocity at facet quad points from each side:
        (nf, 2, nqf, gdim)."""
        Uf = U.reshape(-1)[self._facet_targets]           # (nf, 2, k)
        return (Uf[:, :, None, :, None] * self.psi_tr).sum(3)

    # -- projection (residual assembly) ----------------------------------
    def _scatter(self, loc):
        """(nc, k) local test contributions -> dofs."""
        return scatter_add(self.ndofs, self.dofmap, loc).reshape(self._shape)

    def cell_to_dofs(self, Fq):
        """Vector integrand at cell quads (nc, nq, gdim) against psi."""
        wF = self.wdetJ[..., None] * Fq                   # (nc, nq, gdim)
        return self._scatter((wF[:, None] * self.psi_q).sum((2, 3)))

    def facet_to_dofs(self, Ff):
        """Vector integrand per side at facet quads (nf, 2, nqf, gdim)
        against the side cell's psi traces."""
        wF = self.wlen[:, None, :, None] * Ff             # (nf, 2, nqf, gdim)
        loc = (wF[:, :, :, None, :] * self.psi_tr).sum((2, 4))
        return scatter_add(self.ndofs, self._facet_targets,
                           loc).reshape(self._shape)

    # -- mass ------------------------------------------------------------
    def mass_apply(self, U):
        loc = (self.Mloc * self._cell_dofs(U)[:, None, :]).sum(-1)
        return self._scatter(loc)

    def mass_inverse(self, r):
        """Jacobi-preconditioned CG on the (SPD, facet-coupled) mass,
        ``PCG_ITERATIONS`` iterations."""
        return self._mass_pcg(r)


class RTSpace(HdivSpace):
    """Lowest-order RT function space + assembler over a Mesh2d or a
    SphereMesh."""

    #: Function-compatibility attributes
    family = "RT"
    degree = 1
    PCG_ITERATIONS = 30

    def __init__(self, mesh, asm):
        """:arg asm: an assembly context providing the quadrature rules
        (``asm.space._tab_np``): the P1DG ``DGAssembler`` on planar
        meshes, its tabulations alone on a sphere."""
        self.mesh = mesh
        self.asm = asm

        cf = mesh.cell_facets_np                    # (nc, 3) facet ids
        cs = mesh.cell_sides_np                     # (nc, 3) side of cell
        flen = mesh.facet_len_np
        area = mesh.cell_area_np
        sigma = np.where(cs == 0, 1.0, -1.0)        # (nc, 3)
        elen = flen[cf]                             # (nc, 3)
        tab = asm.space._tab_np
        self.gdim = gdim = mesh.coords_np.shape[1]
        ref_v = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        qp = np.asarray(tab["qp"])                  # (nq, 2)
        qt = np.asarray(tab["qt"])                  # (nqf,) facet params
        J = hdiv_jacobian(mesh)                     # (nc, gdim, 2)

        # cell-quad tabulation: psi (nc, 3, nq, gdim)
        dxi = qp[None, :, :] - ref_v[:, None, :]    # (3, nq, 2)
        xq_rel = np.einsum("cij,vqj->cvqi", J, dxi)
        fac = sigma * elen / (2.0 * area[:, None])  # (nc, 3)
        psi_q = fac[:, :, None, None] * xq_rel
        self.div_np = sigma * elen / area[:, None]  # (nc, 3)
        self.gradfac_np = fac

        # facet traces of the 3 basis functions of each side's cell at
        # the facet quad points: (nf, 2, nqf, 3, gdim)
        fcells = mesh.facet_cells_np
        variant = mesh.facet_variant_np
        ref_fpts = ReferenceElement.facet_points(qt)   # (6, nqf, 2)
        tr = np.zeros((mesh.nf, 2, len(qt), 3, gdim))
        for side in range(2):
            c = fcells[:, side]
            pts = ref_fpts[variant[:, side]]        # (nf, nqf, 2)
            rel = pts[:, None, :, :] - ref_v[None, :, None, :]
            xrel = np.einsum("fij,fvqj->fvqi", J[c], rel)
            tr[:, side] = (fac[c][:, :, None, None] * xrel).transpose(
                0, 2, 1, 3)
        self.cell_facets_np = cf
        self.sigma_np = sigma
        self._set_tables(cf, psi_q, tr, (mesh.nf,))

        dev, dt = mesh.device, mesh.dtype
        self.div = torch.as_tensor(self.div_np, dtype=dt, device=dev)
        self.gradfac = torch.as_tensor(fac, dtype=dt, device=dev)

    def project_vector(self, value):
        """Interpolate a velocity onto the facet-normal dofs: U_f =
        u(midpoint_f) . n_f (exact for RT1 fields).  ``value``: a
        constant vector, a CG1 vector (nv, gdim), per-facet vectors (nf,
        gdim) or ready dofs (nf,)."""
        mesh = self.mesh
        nrm = mesh.facet_normal
        value = torch.as_tensor(value, dtype=mesh.dtype, device=mesh.device)
        if value.dim() <= 1 and tuple(value.shape) != (mesh.nf,):
            return (value.expand(mesh.nf, self.gdim) * nrm).sum(-1)
        if value.dim() == 2 and value.shape[0] == mesh.nv:  # CG1 vector
            fv = mesh.facet_verts
            vmid = 0.5 * (value[fv[:, 0]] + value[fv[:, 1]])
            return (vmid * nrm).sum(-1)
        if tuple(value.shape) == (mesh.nf, self.gdim):
            return (value * nrm).sum(-1)
        if tuple(value.shape) == (mesh.nf,):
            return value
        raise ValueError(f"cannot project {tuple(value.shape)} onto RT dofs")

    # -- evaluation ------------------------------------------------------
    def cell_div(self, U):
        """div(u) per cell (constant): (nc,)."""
        return (self._cell_dofs(U) * self.div).sum(dim=1)

    def facet_normal_values(self, U):
        """Normal velocity at facet quad points (single-valued):
        (nf, nqf)."""
        return U[:, None].expand(self.mesh.nf, self.psi_tr.shape[2])

    def facet_un_mean(self, U):
        """Mean normal velocity per facet (= the dof for RT1)."""
        return U

    def facet_un_quad(self, U):
        """Normal velocity at facet quad points (nf, nqf)."""
        return self.facet_normal_values(U)

    def bnd_normal_to_dofs(self, Fq):
        """Boundary term: integrand (nf, nqf) against the own-facet
        normal trace (= 1 for RT1); the caller masks to boundary
        facets."""
        return (self.wlen * Fq).sum(dim=-1)

    # -- projection (residual assembly) ----------------------------------
    def div_to_dofs(self, Sq):
        """Scalar integrand (nc, nq) against div(psi)."""
        cell_int = (self.wdetJ * Sq).sum(-1)
        return self._scatter(cell_int[:, None] * self.div)

    def grad_to_dofs(self, Gq):
        """Tensor integrand (nc, nq, 2, 2) against grad(psi) (= gradfac
        * I, so G : grad(psi) = gradfac * tr(G))."""
        trG = Gq[..., 0, 0] + Gq[..., 1, 1]
        cell_int = (self.wdetJ * trG).sum(-1)
        return self._scatter(cell_int[:, None] * self.gradfac)
