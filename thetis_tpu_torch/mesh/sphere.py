r"""Triangulated sphere meshes, a 3D-embedded manifold (port of
``thetis_tpu/mesh/sphere.py``).

The reference runs global simulations on icosahedral sphere meshes with
the rt-dg/bdm-dg families (ref ``solver2d.py:314-318`` requires them on
manifolds; Coriolis uses the cell normal, ``shallowwater_eq.py:627-630``).
Here:

* :func:`IcosahedralSphereMesh` builds the refined icosahedron,
* :class:`SphereMesh` has the Mesh2d facet topology (built by the same
  facet builder) and *tangent-plane* geometry: every flat triangular cell
  carries its own plane; facet normals are the averaged, renormalised
  in-plane edge normals of the two cells; ``detJ`` is 2 x the cell area,
  so the RT1/BDM1 x P0 machinery (``fem/rt.py``, ``fem/bdm.py``) works
  with a trailing coordinate dimension of 3.

The sphere has no boundary.  The host tables are float64 numpy, as the
reference's; the device copies go to ``device`` in ``dtype``: the card
unless the caller asks for another device (and without a card a mesh
built with no ``device`` raises).
"""
import numpy as np
import torch

from .mesh2d import Mesh2d, default_device

__all__ = ["IcosahedralSphereMesh", "SphereMesh"]

_DEVICE_TABLES = (
    "coords", "cells", "detJ", "cell_area", "cell_normal", "facet_cells",
    "facet_variant", "facet_normal", "facet_len", "facet_l_normal",
    "facet_marker", "cell_facets", "cell_sides", "cell_hmin", "facet_verts",
)


def _icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=float)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    return verts, faces


def icosahedral_sphere_arrays(refinement_level):
    """Unit-sphere vertices and faces of the icosahedron refined
    ``refinement_level`` times (each face split in four, the new vertices
    pushed out to the sphere), numbered as the reference numbers them."""
    verts, faces = _icosahedron()
    for _ in range(refinement_level):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = 0.5 * (np.asarray(verts[a]) + np.asarray(verts[b]))
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = (int(x) for x in f)
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces


def IcosahedralSphereMesh(radius=1.0, refinement_level=3, *, device=None,
                          dtype=torch.float64):
    """Refined icosahedral sphere (Firedrake's constructor analogue) on
    ``device`` (default: the card) in ``dtype``."""
    verts, faces = icosahedral_sphere_arrays(refinement_level)
    return SphereMesh(radius * verts, faces, radius=radius, device=device,
                      dtype=dtype)


class SphereMesh:
    """Mesh2d-compatible triangulated closed surface in R^3."""

    geometric_dimension = 3

    def __init__(self, coords, cells, radius=1.0, name="sphere", *,
                 device=None, dtype=torch.float64):
        self.device = torch.device(default_device(device))
        self.dtype = dtype
        self.name = name
        self.radius = float(radius)
        self.coords_np = np.asarray(coords, dtype=np.float64)
        self.nv = len(self.coords_np)
        cells = np.asarray(cells, dtype=np.int64)
        # orient cells CCW seen from outside (normal pointing outward)
        p = self.coords_np[cells]
        nvec = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        flip = (nvec * p.mean(axis=1)).sum(1) < 0
        cells = cells.copy()
        cells[flip] = cells[flip][:, [0, 2, 1]]
        self.cells_np = cells.astype(np.int32)
        self.nc = len(cells)
        self.periodic_x_len = self.periodic_y_len = None

        # facet topology: the Mesh2d construction (no boundary)
        Mesh2d._build_facets(self, None)
        if self.facet_is_boundary_np.any():
            raise ValueError("a sphere mesh has no boundary")
        self._build_geometry()
        for tname in _DEVICE_TABLES:
            arr = getattr(self, tname + "_np")
            if arr.dtype.kind == "f":
                t = torch.as_tensor(arr, dtype=dtype, device=self.device)
            else:
                t = torch.as_tensor(arr.astype(np.int64), device=self.device)
            setattr(self, tname, t)
        self.facet_is_interior = torch.as_tensor(
            ~self.facet_is_boundary_np, device=self.device)

    def _build_geometry(self):
        p = self.coords_np[self.cells_np]
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        nvec = np.cross(d1, d2)
        area2 = np.linalg.norm(nvec, axis=1)          # = 2 * area
        self.cell_area_np = 0.5 * area2
        self.detJ_np = area2                          # 2A, like |J| in 2D
        self.cell_normal_np = nvec / area2[:, None]   # outward unit normal

        fv = self.facet_verts_np
        e = self.coords_np[fv[:, 1]] - self.coords_np[fv[:, 0]]
        flen = np.linalg.norm(e, axis=1)
        self.facet_len_np = flen
        # in-plane facet normal: the average of the two adjacent cells'
        # in-plane normals (t x n_cell), renormalised, oriented out of
        # the side-0 cell
        fc = self.facet_cells_np
        t = e / flen[:, None]
        n0 = np.cross(t, self.cell_normal_np[fc[:, 0]])
        n1 = np.cross(t, self.cell_normal_np[fc[:, 1]])
        nf = 0.5 * (n0 + n1)
        nf /= np.linalg.norm(nf, axis=1, keepdims=True)
        cent0 = self.coords_np[self.cells_np[fc[:, 0]]].mean(axis=1)
        mid = 0.5 * (self.coords_np[fv[:, 0]] + self.coords_np[fv[:, 1]])
        sgn = np.sign(((mid - cent0) * nf).sum(1))
        self.facet_normal_np = nf * sgn[:, None]

        self.facet_l_normal_np = self.cell_area_np[fc] / flen[:, None]
        edges = np.stack([
            np.linalg.norm(d1, axis=1),
            np.linalg.norm(p[:, 2] - p[:, 1], axis=1),
            np.linalg.norm(d2, axis=1),
        ], axis=1)
        self.cell_hmin_np = edges.min(axis=1)
        self.cell_hmax_np = edges.max(axis=1)
        self.boundary_len = {}

    @property
    def total_area(self):
        return float(self.cell_area_np.sum())

    def cell_midpoints(self):
        """(nc, 3) host cell centroids (inside the sphere)."""
        return self.coords_np[self.cells_np].mean(axis=1)

    def __repr__(self):
        return (f"SphereMesh({self.name}: {self.nv} vertices, "
                f"{self.nc} cells, {self.nf} facets, R={self.radius}, "
                f"{self.device}, {self.dtype})")
