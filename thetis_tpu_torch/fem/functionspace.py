"""Discontinuous function spaces and Function containers.

Port of the DG part of ``thetis_tpu/fem/functionspace.py``.  DG dofs live
in dense per-cell tensors ``(nc, ndofs)`` (scalars) or ``(nc, ndofs, dim)``
(vectors) on the mesh's device, in the mesh's dtype.  CG spaces are not
ported yet.
"""
import numpy as np
import torch

from .reference_element import ELEMENTS

__all__ = ["FunctionSpace", "Function"]


class FunctionSpace:
    """Scalar or vector DG function space on a :class:`Mesh2d`.

    :arg mesh: Mesh2d (its ``device``/``dtype`` are the space's)
    :arg family: 'DG'
    :arg degree: polynomial degree
    :arg dim: value dimension (1 = scalar, 2 = vector)
    """

    def __init__(self, mesh, family, degree, dim=1, quad_degree=None):
        family = {"Discontinuous Lagrange": "DG"}.get(family, family)
        if family != "DG":
            raise NotImplementedError(
                f"only DG spaces are ported so far, got {family!r}")
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

    # -- tabulations on device -----------------------------------------
    def tab(self, name):
        return self._tab_dev[name]

    phi = property(lambda s: s.tab("phi"))          # (nq, nd)
    dphi = property(lambda s: s.tab("dphi"))        # (nq, nd, 2)
    qw = property(lambda s: s.tab("qw"))            # (nq,)
    qwf = property(lambda s: s.tab("qwf"))          # (nqf,)
    phi_f = property(lambda s: s.tab("phi_f"))      # (6, nqf, nd)
    dphi_f = property(lambda s: s.tab("dphi_f"))    # (6, nqf, nd, 2)

    # -- dof layout ------------------------------------------------------
    def dof_shape(self):
        shape = (self.mesh.nc, self.ndofs)
        return shape + (self.dim,) if self.dim > 1 else shape

    def zero_dofs(self):
        return torch.zeros(self.dof_shape(), dtype=self.mesh.dtype,
                           device=self.mesh.device)

    def dof_coords(self):
        """Physical coordinates of dofs (nc, nd, 2), as a tensor.  Edge
        vectors are period-unwrapped so seam cells of periodic meshes
        place their nodes at the true physical points."""
        mesh = self.mesh
        ref = self.element.dof_coords  # (nd, 2)
        p = mesh.coords_np[mesh.cells_np]  # (nc,3,2)
        J = np.stack([mesh._wrap_dx(p[:, 1] - p[:, 0]),
                      mesh._wrap_dx(p[:, 2] - p[:, 0])], axis=2)
        x = p[:, 0][:, None, :] + np.einsum("cij,dj->cdi", J, ref)
        return torch.as_tensor(x, dtype=mesh.dtype, device=mesh.device)

    def __repr__(self):
        kind = f"Vector({self.dim})" if self.dim > 1 else ""
        return f"{kind}{self.family}{self.degree} on {self.mesh.name}"


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
        """Interpolate ``expr``: a callable ``f(x, y) -> tensor`` evaluated
        at the dof coordinates, a dof-shaped tensor or a scalar."""
        if callable(expr):
            xy = self.function_space.dof_coords()
            expr = expr(xy[..., 0], xy[..., 1])
        return self.assign(expr)

    def __repr__(self):
        return f"Function({self.name}, {self.function_space})"
