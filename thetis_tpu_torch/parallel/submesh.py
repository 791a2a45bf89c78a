r"""Halo-partitioned sub-meshes: the distributed-mesh layer (port of
``thetis_tpu/parallel/submesh.py``; the tables are the reference's, array
for array).

The global cell set is split into contiguous *stripes* over a 1D ring of
partitions, and each partition gets a genuine :class:`SubMesh` — a
``Mesh2d`` covering

    [ owned cells | ghost cells from left nbr | ghost cells from right nbr ]

with all facet/geometry tables sliced from the global mesh (bit-identical
values) and remapped to local indices.  Because a SubMesh is a whole
``Mesh2d``, the *serial* assembler and equation classes run on it
unchanged: the distributed residual is the serial residual evaluated per
partition after one halo refresh (see ``parallel.sharded``).

Facets incident to owned cells are duplicated on both neighbouring
partitions (compute is cheaper than communication); each partition's
scatter-free cell-gather only pulls contributions into its own cells.
Ghost cells' residual rows are discarded, so their (dummy) facet wiring
never influences the result.

Each SubMesh builds its device tensors at construction, as ``Mesh2d``
does, on its partition's device (``HaloPartition(..., devices=)``; by
default the global mesh's device for every partition).
"""
import numpy as np
import torch

from ..mesh.mesh2d import Mesh2d

__all__ = ["SubMesh", "HaloPartition"]


class SubMesh(Mesh2d):
    """A ``Mesh2d`` built from pre-sliced host tables (no facet
    building), its tensors on ``device`` in ``dtype``.

    ``boundary_len`` and ``boundary_markers`` carry the *global* values
    (per-marker boundary lengths are global reductions in the reference
    too, ``thetis/utility.py:821``).  An equation on a SubMesh drops the
    BC specs of markers with no facet in it, as on any mesh
    (``equations/base.py``); the sharded operators never read the rows
    such a marker would reach.
    """

    def __init__(self, tables, name="submesh", *, device, dtype):
        self.name = name
        self.device = torch.device(device)
        self.dtype = dtype
        for k, v in tables.items():
            setattr(self, k, v)
        self.nv = len(self.coords_np)
        self.nc = len(self.cells_np)
        self.nf = len(self.facet_cells_np)
        self.periodic_y_len = None
        self._build_device_tables()


class HaloPartition:
    """Stripe partition with per-device :class:`SubMesh` objects.

    Attributes:
      perm (nc,)            global -> striped cell permutation
      n_loc                 owned cells per device
      halo                  padded ghost count per side
      n_ext                 n_loc + 2*halo (cells per SubMesh)
      submeshes             list of D SubMesh
      ext_ids (D, n_ext)    global cell id backing each local slot
      send_left/right (D, halo)  local owned indices shipped to ring nbrs
      vert_ids (D, NV)      global vertex id backing each local vertex
      devices               the D partitions' torch devices (default: the
                            global mesh's device for each)
    """

    def __init__(self, mesh, n_devices, devices=None):
        nc = mesh.nc
        D = int(n_devices)
        assert nc % D == 0, f"cell count {nc} must divide device count {D}"
        assert mesh.periodic_x_len is None, \
            "periodic-x meshes are not supported by the stripe partition yet"
        self.mesh = mesh
        self.n_devices = D
        if devices is None:
            devices = [mesh.device] * D
        if len(devices) != D:
            raise ValueError(f"{len(devices)} devices for {D} partitions")
        self.devices = [torch.device(x) for x in devices]
        mids = mesh.cell_midpoints()
        perm = np.argsort(mids[:, 0], kind="stable").astype(np.int32)
        self.perm = perm
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(nc, dtype=np.int32)
        self.inv_perm = inv_perm
        n_loc = nc // D
        self.n_loc = n_loc
        owner_of = inv_perm // n_loc

        fc = mesh.facet_cells_np
        f_owner0 = owner_of[fc[:, 0]]
        f_owner1 = owner_of[fc[:, 1]]

        # vertex-to-cell incidence: ghosts are *vertex*-adjacent cells
        # (a superset of the facet-adjacent set) so vertex-coupled
        # operators — the vertex-based slope limiter — see every element
        # sharing a vertex with an owned cell (PyOP2 builds the same
        # closure halo)
        cells_np = mesh.cells_np
        nv_tot = mesh.nv
        v2c_ptr = np.zeros(nv_tot + 1, np.int64)
        np.add.at(v2c_ptr, cells_np.ravel() + 1, 1)
        v2c_ptr = np.cumsum(v2c_ptr)
        order = np.argsort(cells_np.ravel(), kind="stable")
        v2c = (order // 3).astype(np.int32)

        def vertex_closure(cell_set):
            """All cells sharing a vertex with any cell in the set."""
            if not len(cell_set):
                return np.zeros(0, np.int32)
            vs = np.unique(cells_np[cell_set])
            return np.unique(np.concatenate(
                [v2c[v2c_ptr[v]:v2c_ptr[v + 1]] for v in vs]
            ))

        per_dev = []
        max_f, max_h = 0, 0
        for d in range(D):
            owned = perm[d * n_loc:(d + 1) * n_loc]
            # TWO rings of vertex-adjacent cells (the PyOP2 closure-halo
            # analogue, depth 2): ring 1 feeds every vertex-coupled
            # operator (vertex slope limiter) applied to *advected*
            # values, so ring-1 cells must themselves advect correctly —
            # their stencils live in ring 2
            ring1 = vertex_closure(owned)
            ring2 = vertex_closure(ring1)
            owners = owner_of[ring2]
            gl = ring2[owners == (d - 1) % D] if D > 1 else \
                np.zeros(0, np.int32)
            gr = ring2[owners == (d + 1) % D] if D > 1 else \
                np.zeros(0, np.int32)
            far = (owners != d)
            if D > 1:
                far &= (owners != (d - 1) % D) & (owners != (d + 1) % D)
            assert not far.any(), (
                "stripe partition requires ring-only adjacency "
                "(a cell's 2-ring halo spans >1 stripe away); use fewer "
                "devices or a finer mesh"
            )
            # facets touching owned or ring-1 cells: ring-1 assembly is
            # then complete (the far sides are in ring 2)
            r1mask = np.zeros(nc, bool)
            r1mask[ring1] = True
            r1mask[owned] = True
            fsel = np.nonzero(r1mask[fc[:, 0]] | r1mask[fc[:, 1]])[0]
            per_dev.append(dict(fsel=fsel, gl=gl, gr=gr))
            max_f = max(max_f, len(fsel))
            max_h = max(max_h, len(gl), len(gr))
        H = max(1, max_h)
        self.halo = H
        F = max_f + 1  # one trailing dummy facet slot
        self.n_facets_local = F
        n_ext = n_loc + 2 * H
        self.n_ext = n_ext

        # common local vertex count
        NV = 0
        ext_ids = np.zeros((D, n_ext), np.int32)
        for d in range(D):
            owned = perm[d * n_loc:(d + 1) * n_loc]
            gl = per_dev[d]["gl"]
            gr = per_dev[d]["gr"]
            # ghost padding backs onto the neighbour's first owned cell so
            # the shipped (padded) state matches the slot's geometry
            padl = perm[((d - 1) % D) * n_loc]
            padr = perm[((d + 1) % D) * n_loc]
            glp = np.concatenate([gl, np.full(H - len(gl), padl, np.int32)])
            grp = np.concatenate([gr, np.full(H - len(gr), padr, np.int32)])
            ext_ids[d] = np.concatenate([owned, glp, grp])
            NV = max(NV, len(np.unique(mesh.cells_np[ext_ids[d]])))
        self.ext_ids = ext_ids

        send_left = np.zeros((D, H), np.int32)
        send_right = np.zeros((D, H), np.int32)
        for d in range(D):
            # receiver (d+1)'s ghost_left are cells owned by d -> d sends
            # them rightwards, in the receiver's slot order
            gl_of_right = per_dev[(d + 1) % D]["gl"]
            gr_of_left = per_dev[(d - 1) % D]["gr"]
            sr = inv_perm[gl_of_right] - d * n_loc
            sl = inv_perm[gr_of_left] - d * n_loc
            if len(sr):
                assert (sr >= 0).all() and (sr < n_loc).all()
                send_right[d, :len(sr)] = sr
            if len(sl):
                assert (sl >= 0).all() and (sl < n_loc).all()
                send_left[d, :len(sl)] = sl
        self.send_left = send_left
        self.send_right = send_right

        # ----- per-device SubMesh construction ---------------------------
        self.submeshes = []
        vert_ids = np.zeros((D, NV), np.int32)
        for d in range(D):
            eids = ext_ids[d]
            cells_g = mesh.cells_np[eids]  # (n_ext, 3) global vertex ids
            uverts = np.unique(cells_g)
            nvd = len(uverts)
            vids = np.concatenate(
                [uverts, np.full(NV - nvd, uverts[0], np.int32)]
            ).astype(np.int32)
            vert_ids[d] = vids
            # global vertex id -> local index (first occurrence wins so
            # padded duplicates are never produced by the remap)
            vmap = np.full(mesh.nv, -1, np.int64)
            vmap[uverts[::-1]] = np.arange(nvd)[::-1]
            cells_l = vmap[cells_g].astype(np.int32)

            fsel = per_dev[d]["fsel"]
            nfd = len(fsel)
            # global cell id -> ext-local slot (owned first occurrence)
            cmap = np.full(nc, -1, np.int64)
            cmap[eids[::-1]] = np.arange(n_ext)[::-1]
            fcl = cmap[mesh.facet_cells_np[fsel]]
            assert (fcl >= 0).all(), "facet references a cell outside the halo"

            def padf(real, dummy_row, dtype=None):
                real = np.asarray(real)
                out = np.empty((F,) + real.shape[1:],
                               dtype=dtype or real.dtype)
                out[:nfd] = real
                out[nfd:] = dummy_row
                return out

            facet_cells = padf(fcl, [0, 0], np.int32)
            facet_variant = padf(mesh.facet_variant_np[fsel], [0, 1])
            facet_normal = padf(mesh.facet_normal_np[fsel], [1.0, 0.0])
            facet_len = padf(mesh.facet_len_np[fsel], 0.0)
            facet_l_normal = padf(mesh.facet_l_normal_np[fsel], [1.0, 1.0])
            facet_marker = padf(mesh.facet_marker_np[fsel], 0)
            facet_is_bnd = padf(mesh.facet_is_boundary_np[fsel], False)
            facet_local = padf(mesh.facet_local_np[fsel], [0, 0], np.int32)
            fverts_l = vmap[mesh.facet_verts_np[fsel]]
            assert (fverts_l >= 0).all()
            facet_verts = padf(fverts_l, [0, min(1, NV - 1)], np.int32)

            # owned AND ring-1 ghost cells get their (remapped) facet
            # wiring — ring-1 advected values feed the vertex limiter's
            # bounds, so their cell-gather assembly must be complete
            # (their facets are in fsel by construction).  Ring-2 ghosts
            # and pad slots keep the zero-length dummy facet: their rows
            # are only read pre-advance or discarded.
            fmap = np.full(mesh.nf, F - 1, np.int64)
            fmap[fsel] = np.arange(nfd)
            cell_facets = np.full((n_ext, 3), F - 1, np.int32)
            cell_sides = np.zeros((n_ext, 3), np.int32)
            gcf = fmap[mesh.cell_facets_np[eids]]        # (n_ext, 3)
            complete = (gcf != F - 1).all(axis=1)
            complete[:n_loc] = True                      # owned always
            # pad slots (duplicate source cells) stay on the dummy facet
            # so their (wrong-locality) rows never assemble
            first = np.zeros(n_ext, bool)
            _, fidx = np.unique(eids, return_index=True)
            first[fidx] = True
            complete &= first
            cell_facets[complete] = gcf[complete]
            cell_sides[complete] = mesh.cell_sides_np[eids][complete]
            cell_facets[:n_loc] = fmap[mesh.cell_facets_np[eids[:n_loc]]]
            cell_sides[:n_loc] = mesh.cell_sides_np[eids[:n_loc]]

            tables = dict(
                coords_np=mesh.coords_np[vids],
                cells_np=cells_l,
                detJ_np=mesh.detJ_np[eids],
                Jinv_np=mesh.Jinv_np[eids],
                cell_area_np=mesh.cell_area_np[eids],
                cell_hmin_np=mesh.cell_hmin_np[eids],
                cell_hmax_np=mesh.cell_hmax_np[eids],
                facet_cells_np=facet_cells,
                facet_variant_np=facet_variant,
                facet_normal_np=facet_normal,
                facet_len_np=facet_len,
                facet_l_normal_np=facet_l_normal,
                facet_marker_np=facet_marker,
                facet_is_boundary_np=facet_is_bnd,
                facet_local_np=facet_local,
                facet_verts_np=facet_verts,
                cell_facets_np=cell_facets,
                cell_sides_np=cell_sides,
                boundary_markers=list(mesh.boundary_markers),
                boundary_len=dict(mesh.boundary_len),
                periodic_x_len=None,
            )
            self.submeshes.append(
                SubMesh(tables, name=f"{mesh.name}[{d}/{D}]",
                        device=self.devices[d], dtype=mesh.dtype)
            )
        self.vert_ids = vert_ids

    # ----- field redistribution (host side) ------------------------------
    def scatter_cells(self, u):
        """Global-order cell array (nc, ...) -> striped order (nc, ...)
        (the striped-global container of ``parallel.sharded``)."""
        return np.asarray(u)[self.perm]

    def gather_cells(self, u):
        """Striped-order (nc, ...) -> global order."""
        u = np.asarray(u)
        out = np.empty_like(u)
        out[self.perm] = u
        return out

    def local_cell_values(self, u):
        """Global cell array (nc, ...) -> per-partition extended (D, n_ext,
        ...) (for static per-cell coefficients like bathymetry)."""
        return np.asarray(u)[self.ext_ids]

    def local_vertex_values(self, v):
        """Global vertex array (nv, ...) -> per-partition (D, NV, ...)."""
        return np.asarray(v)[self.vert_ids]
