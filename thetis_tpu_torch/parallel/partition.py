r"""Mesh partitioning for multi-device execution (a copy of
``thetis_tpu/parallel/partition.py``: host numpy, the same tables array
for array).

The reference parallelises by horizontal domain decomposition over MPI
ranks with PyOP2 halo exchange (SURVEY.md section 2.10).  The TPU-native
counterpart: cells are reordered into contiguous *stripes* (sorted by
centroid x) and assigned to devices; each device owns ``n_loc`` cells plus
ghost copies of neighbour cells touching shared facets, refreshed each RHS
evaluation (in the port by :func:`~.shard.halo_exchange`).

Facets incident to owned cells are *duplicated* on both neighbouring
devices, so the scatter-free cell-gather of facet contributions stays
device-local (compute is cheaper than communication).
"""
import numpy as np

__all__ = ["StripePartition"]


class StripePartition:
    """Static partition tables for a 1D device ring.

    Attributes (all numpy, stacked over the leading device axis where
    per-device):
      perm           (nc,)        global->striped cell permutation
      n_loc          int          owned cells per device
      halo           int          padded halo size per side
      send_left/right (D, halo)   local indices of owned cells to send
      facet_*        (D, F, ...)  per-device facet tables indexed into the
                                  extended local cell array
                                  [owned | ghost_left | ghost_right]
      cell_facets/_sides (D, n_loc, 3)
    """

    def __init__(self, mesh, n_devices):
        nc = mesh.nc
        assert nc % n_devices == 0, (
            f"cell count {nc} must divide the device count {n_devices}"
        )
        D = n_devices
        self.mesh = mesh
        self.n_devices = D
        mids = mesh.cell_midpoints()
        # stripe by x (stable sort keeps mesh-local ordering within stripes)
        perm = np.argsort(mids[:, 0], kind="stable").astype(np.int32)
        self.perm = perm
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(nc, dtype=np.int32)
        n_loc = nc // D
        self.n_loc = n_loc
        owner_of = inv_perm // n_loc  # device owning each original cell id

        fc = mesh.facet_cells_np
        f_owner0 = owner_of[fc[:, 0]]
        f_owner1 = owner_of[fc[:, 1]]

        # per-device: facets incident to owned cells
        per_dev = []
        max_f = 0
        max_h = 0
        for d in range(D):
            fsel = np.nonzero((f_owner0 == d) | (f_owner1 == d))[0]
            cells_d = fc[fsel]  # original ids
            local = inv_perm[cells_d] - d * n_loc  # in [0, n_loc) if owned
            owners = owner_of[cells_d]
            ghost_left = np.unique(cells_d[owners == (d - 1) % D])
            ghost_right = np.unique(cells_d[owners == (d + 1) % D])
            # only direct ring neighbours may own ghosts (stripe property)
            far = (owners != d) & (owners != (d - 1) % D) & (
                owners != (d + 1) % D
            )
            assert not far.any(), (
                "stripe partition requires ring-only adjacency; "
                "refine the partition"
            )
            per_dev.append(dict(fsel=fsel, ghost_left=ghost_left,
                                ghost_right=ghost_right))
            max_f = max(max_f, len(fsel))
            max_h = max(max_h, len(ghost_left), len(ghost_right))
        self.halo = max_h

        F = max_f
        self.n_facets_local = F
        fcells = np.zeros((D, F, 2), np.int32)
        fvar = np.zeros((D, F, 2), np.int32)
        fnormal = np.zeros((D, F, 2))
        flen = np.zeros((D, F))
        flnormal = np.ones((D, F, 2))
        fmask_int = np.zeros((D, F), bool)
        fmask_bnd = np.zeros((D, F), bool)
        fvalid = np.zeros((D, F), bool)
        cell_facets = np.zeros((D, n_loc, 3), np.int32)
        cell_sides = np.zeros((D, n_loc, 3), np.int32)
        send_left = np.zeros((D, max_h), np.int32)
        send_right = np.zeros((D, max_h), np.int32)
        for d in range(D):
            info = per_dev[d]
            fsel = info["fsel"]
            nfd = len(fsel)
            # extended local index for any original cell id seen by device d
            ext_index = {}
            for i, g in enumerate(range(d * n_loc, (d + 1) * n_loc)):
                ext_index[int(perm[g])] = i
            for i, g in enumerate(info["ghost_left"]):
                ext_index[int(g)] = n_loc + i
            for i, g in enumerate(info["ghost_right"]):
                ext_index[int(g)] = n_loc + self.halo + i
            remap = np.vectorize(lambda c: ext_index[int(c)])
            fcells[d, :nfd] = remap(fc[fsel])
            fvar[d, :nfd] = mesh.facet_variant_np[fsel]
            fnormal[d, :nfd] = mesh.facet_normal_np[fsel]
            flen[d, :nfd] = mesh.facet_len_np[fsel]
            flnormal[d, :nfd] = mesh.facet_l_normal_np[fsel]
            fmask_int[d, :nfd] = ~mesh.facet_is_boundary_np[fsel]
            fmask_bnd[d, :nfd] = mesh.facet_is_boundary_np[fsel]
            fvalid[d, :nfd] = True
            # local facet id for each global facet on this device
            fid = {int(f): i for i, f in enumerate(fsel)}
            cf_global = mesh.cell_facets_np[perm[d * n_loc:(d + 1) * n_loc]]
            cs = mesh.cell_sides_np[perm[d * n_loc:(d + 1) * n_loc]]
            cell_facets[d] = np.vectorize(lambda f: fid[int(f)])(cf_global)
            cell_sides[d] = cs
            # send lists: cells this device owns that are the *right* ghosts
            # of the left neighbour, and vice versa
            gl_of_right = per_dev[(d + 1) % D]["ghost_left"]
            gr_of_left = per_dev[(d - 1) % D]["ghost_right"]
            sr = inv_perm[gl_of_right] - d * n_loc
            sl = inv_perm[gr_of_left] - d * n_loc
            if len(sr):
                send_right[d, :len(sr)] = sr
            if len(sl):
                send_left[d, :len(sl)] = sl

        self.tables = dict(
            facet_cells=fcells,
            facet_variant=fvar,
            facet_normal=fnormal,
            facet_len=flen,
            facet_l_normal=flnormal,
            facet_mask_int=fmask_int,
            facet_mask_bnd=fmask_bnd,
            facet_valid=fvalid,
            cell_facets=cell_facets,
            cell_sides=cell_sides,
            send_left=send_left,
            send_right=send_right,
            detJ=mesh.detJ_np[self.perm].reshape(D, n_loc),
            Jinv=mesh.Jinv_np[self.perm].reshape(D, n_loc, 2, 2),
        )

    # -- field redistribution ------------------------------------------
    def scatter_cells(self, u):
        """Global cell dof array (nc, ...) -> (D, n_loc, ...)."""
        u = np.asarray(u)
        return u[self.perm].reshape(
            (self.n_devices, self.n_loc) + u.shape[1:]
        )

    def gather_cells(self, u_sharded):
        """(D, n_loc, ...) -> global (nc, ...)."""
        u = np.asarray(u_sharded).reshape(
            (self.mesh.nc,) + np.asarray(u_sharded).shape[2:]
        )
        out = np.empty_like(u)
        out[self.perm] = u
        return out
