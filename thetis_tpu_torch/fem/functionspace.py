"""Function spaces and Function containers.

Port of ``thetis_tpu/fem/functionspace.py``.  DG dofs live in dense
per-cell tensors ``(nc, ndofs)`` (scalars) or ``(nc, ndofs, dim)``
(vectors); CG P1 dofs live in per-vertex tensors ``(nv[, dim])`` with the
cell->vertex map as the cell node map; CG P2 numbers the vertices first
and then one dof per facet, at ``nv + facet index`` (the reference's
numbering, ref L61-66).  Every tensor is on the mesh's device, in the
mesh's dtype.
"""
import numpy as np
import torch

from .reference_element import ELEMENTS

__all__ = ["FunctionSpace", "VectorFunctionSpace", "get_functionspace",
           "Function", "SpatialCoordinate"]


class FunctionSpace:
    """Scalar or vector function space on a :class:`Mesh2d`.

    :arg mesh: Mesh2d (its ``device``/``dtype`` are the space's)
    :arg family: 'DG' or 'CG'
    :arg degree: polynomial degree (CG: 1 or 2)
    :arg dim: value dimension (1 = scalar, 2 = vector)
    """

    def __init__(self, mesh, family, degree, dim=1, quad_degree=None):
        family = {"Discontinuous Lagrange": "DG", "Lagrange": "CG",
                  "P": "CG"}.get(family, family)
        if family == "CG" and degree == 0:
            raise ValueError("CG0 does not exist")
        if family == "CG" and degree > 2:
            raise NotImplementedError(f"CG{degree} is not implemented")
        if family not in ("DG", "CG"):
            raise ValueError(f"unknown function space family {family!r}")
        self.mesh = mesh
        self.family = family
        self.degree = degree
        self.dim = dim
        self.element = ELEMENTS[(family, degree)]
        self.ndofs = self.element.ndofs
        # quadrature degree: 2p+1 like the reference (tracer_eq_2d.py:73),
        # bumped to the nearest implemented rule
        self.quad_degree = quad_degree or max(2 * degree + 1, 2)
        self._tab_np = self.element.tabulate(self.quad_degree)
        self._tab_dev = {
            k: torch.as_tensor(v, dtype=mesh.dtype, device=mesh.device)
            for k, v in self._tab_np.items()
        }
        self.is_dg = family == "DG"
        if self.is_dg:
            self.node_count = mesh.nc * self.ndofs
            self.cell_node_map_np = None  # implicit: (c, d) -> c*ndofs + d
        elif degree == 1:
            self.node_count = mesh.nv
            self.cell_node_map_np = mesh.cells_np
        else:
            # vertex dofs, then one dof per facet (its midpoint)
            self.node_count = mesh.nv + mesh.nf
            self.cell_node_map_np = np.concatenate(
                [mesh.cells_np, mesh.nv + mesh.cell_facets_np],
                axis=1).astype(np.int32)
            self._cnm = torch.as_tensor(self.cell_node_map_np,
                                        dtype=torch.int64, device=mesh.device)

    # -- tabulations on device -----------------------------------------
    def tab(self, name):
        return self._tab_dev[name]

    phi = property(lambda s: s.tab("phi"))          # (nq, nd)
    dphi = property(lambda s: s.tab("dphi"))        # (nq, nd, 2)
    qw = property(lambda s: s.tab("qw"))            # (nq,)
    qwf = property(lambda s: s.tab("qwf"))          # (nqf,)
    phi_f = property(lambda s: s.tab("phi_f"))      # (6, nqf, nd)
    dphi_f = property(lambda s: s.tab("dphi_f"))    # (6, nqf, nd, 2)

    @property
    def cell_node_map(self):
        """(nc, nd) int64 cell -> CG node map on the mesh's device."""
        return self.mesh.cells if self.degree == 1 else self._cnm

    # -- dof layout ------------------------------------------------------
    def dof_shape(self):
        shape = ((self.mesh.nc, self.ndofs) if self.is_dg
                 else (self.node_count,))
        return shape + (self.dim,) if self.dim > 1 else shape

    def zero_dofs(self):
        return torch.zeros(self.dof_shape(), dtype=self.mesh.dtype,
                           device=self.mesh.device)

    def cell_dofs(self, u):
        """Per-cell dof values (nc, nd[, dim]) for any space."""
        if self.is_dg:
            return u
        return u[self.cell_node_map]

    def dof_coords(self):
        """Physical coordinates of dofs, shaped like a scalar dof array
        plus a trailing coordinate axis: (nc, nd, 2) for DG, (nv, 2) for
        CG1, (nv + nf, 2) for CG2 (the vertices, then the facet
        midpoints).  Edge vectors are period-unwrapped so seam cells and
        facets of periodic meshes place their nodes at the true physical
        points (ref L118-135)."""
        mesh = self.mesh
        if not self.is_dg:
            x = mesh.coords_np
            if self.degree == 2:
                fv = mesh.facet_verts_np
                a = x[fv[:, 0]]
                x = np.concatenate(
                    [x, a + 0.5 * mesh._wrap_dx(x[fv[:, 1]] - a)], axis=0)
            return torch.as_tensor(x, dtype=mesh.dtype, device=mesh.device)
        ref = self.element.dof_coords  # (nd, 2)
        p = mesh.coords_np[mesh.cells_np]  # (nc,3,2)
        J = np.stack([mesh._wrap_dx(p[:, 1] - p[:, 0]),
                      mesh._wrap_dx(p[:, 2] - p[:, 0])], axis=2)
        x = p[:, 0][:, None, :] + np.einsum("cij,dj->cdi", J, ref)
        return torch.as_tensor(x, dtype=mesh.dtype, device=mesh.device)

    def __eq__(self, other):
        return (
            isinstance(other, FunctionSpace)
            and self.mesh is other.mesh
            and self.family == other.family
            and self.degree == other.degree
            and self.dim == other.dim
        )

    def __hash__(self):
        return hash((id(self.mesh), self.family, self.degree, self.dim))

    def __repr__(self):
        kind = f"Vector({self.dim})" if self.dim > 1 else ""
        return f"{kind}{self.family}{self.degree} on {self.mesh.name}"


def VectorFunctionSpace(mesh, family, degree, dim=2):
    """A vector-valued :class:`FunctionSpace` (ref L156-157)."""
    return FunctionSpace(mesh, family, degree, dim=dim)


def get_functionspace(mesh, h_family, h_degree, vector=False, dim=2,
                      **kwargs):
    """The reference's helper (``thetis/utility.py:163``; ref L160-162)."""
    return FunctionSpace(mesh, h_family, h_degree, dim=dim if vector else 1)


class Function:
    """A field: dof tensor + space."""

    def __init__(self, function_space, name=None, data=None):
        self.function_space = function_space
        self.name = name or "function"
        mesh = function_space.mesh
        self.data = (
            function_space.zero_dofs() if data is None
            else torch.as_tensor(data, dtype=mesh.dtype, device=mesh.device)
        )

    def assign(self, value):
        if isinstance(value, Function):
            value = value.data
        value = torch.as_tensor(value, dtype=self.data.dtype,
                                device=self.data.device)
        self.data = value.expand(self.data.shape).clone()
        return self

    def interpolate(self, expr):
        """Interpolate ``expr``: a callable ``f(x, y) -> tensor or array``
        evaluated at the dof coordinates, a dof-shaped tensor or a scalar.
        The callable gets the coordinates on the mesh's device; one that
        cannot run there gets them again on the host: numpy reads the
        reference's arrays but no CUDA tensor (a script's
        ``np.where(x <= 50.0, ...)`` raises a TypeError), and numpy's
        host results do not mix with the device's tensors (a
        RuntimeError). The value then goes to the mesh's device."""
        if callable(expr):
            xy = self.function_space.dof_coords()
            try:
                expr = expr(xy[..., 0], xy[..., 1])
            except (TypeError, RuntimeError):
                if xy.device.type == "cpu":
                    raise
                xy = xy.cpu()
                expr = expr(xy[..., 0], xy[..., 1])
        return self.assign(expr)

    def __repr__(self):
        return f"Function({self.name}, {self.function_space})"


def SpatialCoordinate(mesh_or_space):
    """Dof-coordinate tensors ``(x, y)``: the vertex coordinates (the P1
    CG layout, the common use in demo scripts) for a mesh, the space's dof
    coordinates for a :class:`FunctionSpace`."""
    if isinstance(mesh_or_space, FunctionSpace):
        xy = mesh_or_space.dof_coords()
    else:
        m = mesh_or_space
        xy = torch.as_tensor(m.coords_np, dtype=m.dtype, device=m.device)
    return xy[..., 0], xy[..., 1]
