"""Unstructured 2D triangle mesh with static host tables and device tensors.

Port of ``thetis_tpu/mesh/mesh2d.py``.  All topology is precomputed on the
host into flat numpy tables (``*_np`` attributes, identical to the
reference's); the device copies are torch tensors on the mesh's
``device``:

* ``cells`` (nc,3)        cell -> vertex indices (CCW oriented)
* ``facet_cells`` (nf,2)  facet -> [side0 cell, side1 cell] (side1==side0 on
                          the boundary)
* ``facet_variant`` (nf,2) trace-tabulation variant per side (see
                          ``fem.reference_element``)
* ``facet_normal`` (nf,2) unit normal pointing *out of* the side-0 cell
* ``cell_facets``/``cell_sides`` (nc,3): each cell gathers its three facet
  contributions rather than facets scattering into cells.

Index tables are int64 on the device (torch's indexing type); float
tables take the mesh's ``dtype``.
"""
import os

import numpy as np
import torch

__all__ = ["Mesh2d", "default_device"]


def default_device(device):
    """The device of a mesh: ``device`` when given, else the card; without
    a card this raises rather than fall back to the CPU quietly."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: meshes go to the card unless "
            'asked otherwise; pass device="cpu" to run on the CPU')
    return "cuda"


_DEVICE_TABLES = (
    "coords", "cells", "detJ", "Jinv", "cell_area", "facet_cells",
    "facet_variant", "facet_normal", "facet_len", "facet_l_normal",
    "facet_marker", "cell_facets", "cell_sides", "cell_hmin",
    "facet_verts",
)


class Mesh2d:
    def __init__(self, coords, cells, boundary_markers=None, name="mesh2d",
                 periodic_x_len=None, periodic_y_len=None, *, device=None,
                 dtype=torch.float64):
        """
        :arg coords: (nv, 2) float vertex coordinates
        :arg cells: (nc, 3) int vertex indices
        :arg boundary_markers: optional (n_bnd_edges, 3) int array of
            ``(v0, v1, marker)`` rows, or a callable ``f(midpoints) ->
            markers`` evaluated at boundary-edge midpoints.  Unmarked
            boundary facets get marker 0 treated as land.
        :arg periodic_x_len: if set, the mesh is periodic in x with this
            period: all coordinate *differences* used in the geometry are
            unwrapped modulo the period.
        :arg device: torch device of every tensor built on this mesh
            (default: the card, :func:`default_device`)
        :arg dtype: floating dtype of every tensor built on this mesh
        """
        coords = np.asarray(coords, dtype=np.float64)
        cells = np.asarray(cells, dtype=np.int32)
        if coords.ndim != 2 or coords.shape[1] != 2:
            raise ValueError(f"coords must be (nv, 2), got {coords.shape}")
        if cells.ndim != 2 or cells.shape[1] != 3:
            raise ValueError(f"cells must be (nc, 3), got {cells.shape}")
        self.device = torch.device(default_device(device))
        self.dtype = dtype
        self.name = name
        self.coords_np = coords
        self.nv = len(coords)
        self.periodic_x_len = periodic_x_len
        self.periodic_y_len = periodic_y_len

        # enforce CCW orientation (seam-aware differences)
        p = coords[cells]
        d1 = self._wrap_dx(p[:, 1] - p[:, 0])
        d2 = self._wrap_dx(p[:, 2] - p[:, 0])
        det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        flip = det < 0
        cells = cells.copy()
        cells[flip] = cells[flip][:, [0, 2, 1]]
        self.cells_np = cells
        self.nc = len(cells)

        self._build_facets(boundary_markers)
        self._build_geometry()
        self._build_device_tables()

    def _build_device_tables(self):
        """The device tensors of the host tables, on ``self.device`` in
        ``self.dtype`` (index tables int64)."""
        for tname in _DEVICE_TABLES:
            arr = getattr(self, tname + "_np")
            if arr.dtype.kind == "f":
                t = torch.as_tensor(arr, dtype=self.dtype,
                                    device=self.device)
            else:
                t = torch.as_tensor(arr.astype(np.int64), device=self.device)
            setattr(self, tname, t)
        self.facet_is_interior = torch.as_tensor(
            ~self.facet_is_boundary_np, device=self.device)

    # ------------------------------------------------------------------
    def _build_facets(self, boundary_markers):
        cells = self.cells_np
        nc = self.nc
        native_tables = None
        if os.environ.get("THETIS_TPU_NATIVE", "1") != "0":
            from ..native import build_facets_native

            native_tables = build_facets_native(cells, self.nv)
        if native_tables is not None:
            # C++ graph builder (native/meshbuild.cpp)
            cell_facets = native_tables["cell_facets"]
            cell_sides = native_tables["cell_sides"]
            facet_cells = native_tables["facet_cells"]
            facet_local = native_tables["facet_local"]
            self.facet_verts_np = native_tables["facet_verts"]
            is_bnd = native_tables["facet_is_boundary"]
            self.facet_is_boundary_np = is_bnd
            nf = len(facet_cells)
            self.nf = nf
            av = self.facet_verts_np[:, 0]
            bv = self.facet_verts_np[:, 1]
            a = np.stack([cells[:, 1], cells[:, 2], cells[:, 0]], axis=1)
        else:
            # vectorised numpy fallback
            # edge (cell, local_facet) -> vertex pair along the cell's
            # traversal; local facet i goes from vertex (i+1)%3 to (i+2)%3
            a = np.stack([cells[:, 1], cells[:, 2], cells[:, 0]], axis=1)
            b = np.stack([cells[:, 2], cells[:, 0], cells[:, 1]], axis=1)
            lo = np.minimum(a, b).ravel()
            hi = np.maximum(a, b).ravel()
            key = lo.astype(np.int64) * self.nv + hi.astype(np.int64)
            uniq, first_idx, inverse, counts = np.unique(
                key, return_index=True, return_inverse=True,
                return_counts=True
            )
            nf = len(uniq)
            self.nf = nf
            # facet id for each (cell, local) slot
            cell_facets = inverse.reshape(nc, 3).astype(np.int32)

            # side assignment: the slot at first_idx is side 0
            flat_idx = np.arange(nc * 3)
            is_side0 = first_idx[inverse] == flat_idx
            cell_sides = np.where(is_side0, 0, 1).reshape(nc, 3).astype(
                np.int32
            )

            facet_cells = np.zeros((nf, 2), dtype=np.int32)
            facet_local = np.zeros((nf, 2), dtype=np.int32)
            slot_cell = np.repeat(np.arange(nc, dtype=np.int32), 3)
            slot_local = np.tile(np.arange(3, dtype=np.int32), nc)
            side_flat = cell_sides.ravel()
            f_flat = cell_facets.ravel()
            facet_cells[f_flat, side_flat] = slot_cell
            facet_local[f_flat, side_flat] = slot_local
            # boundary facets: side1 mirrors side0
            is_bnd = counts == 1
            facet_cells[is_bnd, 1] = facet_cells[is_bnd, 0]
            facet_local[is_bnd, 1] = facet_local[is_bnd, 0]
            self.facet_is_boundary_np = is_bnd

            # side-0 traversal defines the facet parameterisation
            av = a.ravel()[first_idx]
            bv = b.ravel()[first_idx]
            self.facet_verts_np = np.stack([av, bv], axis=1).astype(np.int32)

        # variants: side0 = forward; side1 forward iff its traversal matches
        a1 = a[facet_cells[:, 1], facet_local[:, 1]]
        side1_reversed = a1 != av  # side1 starts at bv in a consistent mesh
        facet_variant = np.zeros((nf, 2), dtype=np.int32)
        facet_variant[:, 0] = facet_local[:, 0] * 2
        facet_variant[:, 1] = (facet_local[:, 1] * 2
                               + side1_reversed.astype(np.int32))
        self.facet_cells_np = facet_cells
        self.facet_local_np = facet_local
        self.facet_variant_np = facet_variant
        self.cell_facets_np = cell_facets
        self.cell_sides_np = cell_sides

        # boundary markers
        markers = np.zeros(nf, dtype=np.int32)
        bnd_ids = np.nonzero(is_bnd)[0]
        if boundary_markers is not None and len(bnd_ids):
            mids = 0.5 * (
                self.coords_np[av[bnd_ids]] + self.coords_np[bv[bnd_ids]]
            )
            if callable(boundary_markers):
                markers[bnd_ids] = np.asarray(
                    boundary_markers(mids), dtype=np.int32
                )
            else:
                bm = np.asarray(boundary_markers, dtype=np.int64)
                bkey = (
                    np.minimum(bm[:, 0], bm[:, 1]) * self.nv
                    + np.maximum(bm[:, 0], bm[:, 1])
                )
                lo_b = np.minimum(av[bnd_ids], bv[bnd_ids]).astype(np.int64)
                hi_b = np.maximum(av[bnd_ids], bv[bnd_ids]).astype(np.int64)
                fkey = lo_b * self.nv + hi_b
                order = np.argsort(bkey)
                pos = np.searchsorted(bkey[order], fkey)
                pos = np.clip(pos, 0, len(bkey) - 1)
                hit = bkey[order][pos] == fkey
                markers[bnd_ids[hit]] = bm[order][pos[hit], 2].astype(np.int32)
        self.facet_marker_np = markers
        self.boundary_markers = (
            sorted(int(m) for m in np.unique(markers[bnd_ids]))
            if len(bnd_ids) else [])

    # ------------------------------------------------------------------
    def _wrap_dx(self, d):
        """Unwrap x/y-components of coordinate differences on a periodic
        mesh (shortest representative modulo the period)."""
        if self.periodic_x_len is None and self.periodic_y_len is None:
            return d
        d = d.copy()
        if self.periodic_x_len is not None:
            L = self.periodic_x_len
            d[..., 0] -= L * np.round(d[..., 0] / L)
        if self.periodic_y_len is not None:
            Ly = self.periodic_y_len
            d[..., 1] -= Ly * np.round(d[..., 1] / Ly)
        return d

    def _build_geometry(self):
        coords, cells = self.coords_np, self.cells_np
        p0 = coords[cells[:, 0]]
        p1 = coords[cells[:, 1]]
        p2 = coords[cells[:, 2]]
        # Jacobian of x = p0 + J @ (xi, eta)
        J = np.stack([self._wrap_dx(p1 - p0), self._wrap_dx(p2 - p0)],
                     axis=2)  # (nc, 2, 2), columns
        detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        if not np.all(detJ > 0):
            raise ValueError("degenerate or mis-oriented cells")
        Jinv = np.empty_like(J)
        Jinv[:, 0, 0] = J[:, 1, 1] / detJ
        Jinv[:, 0, 1] = -J[:, 0, 1] / detJ
        Jinv[:, 1, 0] = -J[:, 1, 0] / detJ
        Jinv[:, 1, 1] = J[:, 0, 0] / detJ
        self.detJ_np = detJ
        self.Jinv_np = Jinv
        self.cell_area_np = 0.5 * detJ

        fv = self.facet_verts_np
        e = self._wrap_dx(coords[fv[:, 1]] - coords[fv[:, 0]])
        flen = np.linalg.norm(e, axis=1)
        # outward normal of the side-0 (CCW) cell: rotate edge -90 degrees
        normal = np.stack([e[:, 1], -e[:, 0]], axis=1) / flen[:, None]
        self.facet_len_np = flen
        self.facet_normal_np = normal

        # characteristic length used in the SIPG penalty
        # (CellVolume/FacetArea analogue, shallowwater_eq.py:577)
        areas = self.cell_area_np[self.facet_cells_np]  # (nf,2)
        self.facet_l_normal_np = areas / flen[:, None]

        # min/max edge length per cell
        edges = np.stack(
            [
                np.linalg.norm(self._wrap_dx(p1 - p0), axis=1),
                np.linalg.norm(self._wrap_dx(p2 - p1), axis=1),
                np.linalg.norm(self._wrap_dx(p0 - p2), axis=1),
            ],
            axis=1,
        )
        self.cell_hmin_np = edges.min(axis=1)
        self.cell_hmax_np = edges.max(axis=1)

        # per-marker boundary length (utility.py:821 compute_boundary_length)
        self.boundary_len = {}
        for m in self.boundary_markers:
            sel = self.facet_marker_np == m
            self.boundary_len[m] = float(self.facet_len_np[sel].sum())

    @property
    def total_area(self):
        """Domain area (host float)."""
        return float(self.cell_area_np.sum())

    def cell_midpoints(self):
        """(nc, 2) host cell centroids."""
        return self.coords_np[self.cells_np].mean(axis=1)

    def __repr__(self):
        return (
            f"Mesh2d({self.name}: {self.nv} vertices, {self.nc} cells, "
            f"{self.nf} facets, markers={self.boundary_markers}, "
            f"{self.device}, {self.dtype})"
        )
