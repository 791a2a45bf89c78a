"""Vertex-based P1DG slope limiters (Kuzmin 2010), for triangles and
prisms.

Port of ``thetis_tpu/equations/limiter.py``.  :class:`VertexBasedP1DGLimiter`
(the 2D one, ref ``:23-82``):

1. per-cell centroid means (the mean of the three nodal values),
2. per-vertex bounds = min/max over the adjacent centroids
   (``scatter_reduce`` ``amax``/``amin`` over the cell -> vertex map),
   extended on exterior facets by the facet mean so boundary extrema are
   not clipped,
3. per-cell limiting factor alpha applied to the deviation from the mean;
   the components of a vector field are limited independently, in one
   pass.

:class:`VertexBasedP1DGLimiter3D`:

1. per-(cell, layer) centroid means,
2. per-vertex bounds = min/max over the adjacent centroids (gathers over
   a vertex -> incident cells table), extended at the surface, the bed
   and lateral walls by the boundary face means so boundary extrema are
   not clipped,
3. per-(cell, layer) limiting factor alpha applied to the deviation from
   the mean.

Element means are preserved and uniform fields pass through unchanged.
The incidence tables are built on the host in numpy, as the reference
builds them.
"""
import numpy as np
import torch

__all__ = ["VertexBasedP1DGLimiter", "VertexBasedP1DGLimiter3D"]


class VertexBasedP1DGLimiter:
    """Vertex-based slope limiter for P1DG triangle fields (nc, 3[, k])
    (ref ``limiter.py:23-82``)."""

    def __init__(self, space):
        if space.family != "DG" or space.degree != 1:
            raise ValueError("vertex-based limiter requires P1DG")
        self.space = space
        self.mesh = mesh = space.mesh
        dev = mesh.device
        self.cells = mesh.cells                   # (nc, 3): node d at vertex d
        # boundary facets: owner cell and the two local nodes on the facet
        # (local facet i is opposite vertex i)
        bnd = np.nonzero(mesh.facet_is_boundary_np)[0]
        self._has_bnd = len(bnd) > 0
        own = np.asarray(mesh.facet_cells_np)[bnd, 0].astype(np.int64)
        lf = np.asarray(mesh.facet_local_np)[bnd, 0].astype(np.int64)
        n1, n2 = (lf + 1) % 3, (lf + 2) % 3
        cells_np = np.asarray(mesh.cells_np)
        self.bnd_cell = torch.as_tensor(own, device=dev)
        self.bnd_n1 = torch.as_tensor(n1, device=dev)
        self.bnd_n2 = torch.as_tensor(n2, device=dev)
        # the vertices each bound takes a value at: every cell's three,
        # then each boundary facet's two
        self._targets = torch.as_tensor(np.concatenate(
            [cells_np.ravel(), cells_np[own, n1], cells_np[own, n2]]
        ).astype(np.int64), device=dev)

    def _apply_multi(self, u):
        """Limit ``u`` (nc, 3, k), all k components in one pass."""
        nv = self.mesh.nv
        k = u.shape[-1]
        centroid = u.mean(dim=1)                  # (nc, k)
        src = [centroid[:, None].expand(-1, 3, -1).reshape(-1, k)]
        if self._has_bnd:
            fmean = 0.5 * (u[self.bnd_cell, self.bnd_n1]
                           + u[self.bnd_cell, self.bnd_n2])  # (nb, k)
            src += [fmean, fmean]
        src = torch.cat(src)
        idx = self._targets[:, None].expand(-1, k)
        big = torch.finfo(u.dtype).max
        qmax = u.new_full((nv, k), -big).scatter_reduce(
            0, idx, src, "amax")
        qmin = u.new_full((nv, k), big).scatter_reduce(0, idx, src, "amin")
        vmax = qmax[self.cells]                   # (nc, 3, k)
        vmin = qmin[self.cells]
        cb = centroid[:, None]
        dev = u - cb
        eps = 1e-14
        up = torch.where(dev > eps, (vmax - cb) / torch.clamp_min(dev, eps),
                         1.0)
        dn = torch.where(dev < -eps,
                         (vmin - cb) / torch.clamp_max(dev, -eps), 1.0)
        alpha = torch.clamp(torch.minimum(up, dn), 0.0, 1.0).amin(dim=1)
        return cb + alpha[:, None] * dev

    def apply(self, u):
        """Limit a (nc, 3) or (nc, 3, k) dof tensor (each component on
        its own); returns the limited tensor."""
        if u.dim() == 3:
            return self._apply_multi(u)
        return self._apply_multi(u[..., None])[..., 0]


class VertexBasedP1DGLimiter3D:
    """Vertex-based slope limiter for prism P1DG fields (nc, 3, nz, 2[, k]);
    element (c, l) touches the 3D vertices (v in cell c) x (interfaces l,
    l+1)."""

    #: incidence-table widths; incidence beyond the width is truncated
    #: (real triangle meshes stay well below)
    MAX_VERTEX_DEGREE = 24
    MAX_VERTEX_BND_FACETS = 4

    def __init__(self, mesh2d, n_layers):
        self.mesh = mesh2d
        self.nz = int(n_layers)
        dev = mesh2d.device
        cells_np = np.asarray(mesh2d.cells_np)
        nv = mesh2d.nv
        self.cells = mesh2d.cells                 # (nc, 3) int64

        # vertex -> incident cells, padded by duplicating the first
        # incident cell (idempotent under max/min)
        K = self.MAX_VERTEX_DEGREE
        counts = np.zeros(nv, np.int64)
        np.add.at(counts, cells_np.ravel(), 1)
        order = np.argsort(cells_np.ravel(), kind="stable")
        ptr = np.concatenate([[0], np.cumsum(counts)])
        flat = (order // 3).astype(np.int64)
        v2c = np.empty((nv, K), np.int64)
        for v in range(nv):
            inc = flat[ptr[v]:ptr[v + 1]]
            if len(inc) == 0:
                inc = np.zeros(1, np.int64)
            elif len(inc) > K:
                inc = np.unique(inc)[:K]
            v2c[v, :len(inc)] = inc
            v2c[v, len(inc):] = inc[0]
        self.v2c = torch.as_tensor(v2c, device=dev)

        # vertex -> incident boundary facets (lateral walls), padded by
        # duplication; vertices with none point at facet 0 with a mask
        is_bnd = np.asarray(mesh2d.facet_is_boundary_np)
        fverts = np.asarray(mesh2d.facet_verts_np)
        KB = self.MAX_VERTEX_BND_FACETS
        v2f = np.zeros((nv, KB), np.int64)
        v2f_n = np.zeros(nv, np.int64)
        for f in np.nonzero(is_bnd)[0]:
            for v in fverts[f]:
                if v2f_n[v] < KB:
                    v2f[v, v2f_n[v]] = f
                    v2f_n[v] += 1
        for v in range(nv):
            if v2f_n[v]:
                v2f[v, v2f_n[v]:] = v2f[v, 0]
        self._has_bnd = bool(is_bnd.any())
        self.v2f = torch.as_tensor(v2f, device=dev)
        self.v2f_mask = torch.as_tensor(v2f_n > 0, device=dev)
        own = np.asarray(mesh2d.facet_cells_np)[:, 0].astype(np.int64)
        lf = np.asarray(mesh2d.facet_local_np)[:, 0].astype(np.int64)
        self.bnd_cell = torch.as_tensor(own, device=dev)
        self.bnd_n1 = torch.as_tensor((lf + 1) % 3, device=dev)
        self.bnd_n2 = torch.as_tensor((lf + 2) % 3, device=dev)
        self.layer_idx = (self.cells[:, :, None] * self.nz
                          + torch.arange(self.nz, device=dev))  # (nc, 3, nz)

    def _apply_multi(self, u):
        """Limit ``u`` (nc, 3, nz, 2, k), all k components independently
        in one pass."""
        nz = self.nz
        nc, _, _, _, k = u.shape
        nv = self.v2c.shape[0]
        centroid = u.mean(dim=(1, 3))             # (nc, nz, k)
        bot_mean = u[:, :, 0, 0].mean(dim=1)      # (nc, k)
        top_mean = u[:, :, nz - 1, 1].mean(dim=1)
        # one vertex gather: [centroids | bottom means | top means]
        table = torch.cat([centroid.reshape(nc, nz * k), bot_mean, top_mean],
                          dim=1)
        tv = table[self.v2c]                      # (nv, K, (nz+2) k)
        tmax = tv.amax(dim=1)
        tmin = tv.amin(dim=1)
        cmax = tmax[:, :nz * k].reshape(nv, nz, k)
        cmin = tmin[:, :nz * k].reshape(nv, nz, k)
        fb_max = tmax[:, nz * k:(nz + 1) * k]     # (nv, k)
        fb_min = tmin[:, nz * k:(nz + 1) * k]
        ft_max = tmax[:, (nz + 1) * k:]
        ft_min = tmin[:, (nz + 1) * k:]
        # interface bounds: merge the two adjacent layers; the surface
        # and bottom interfaces also take the horizontal face means, so
        # monotone vertical profiles pass untouched
        qmax = torch.cat([
            torch.maximum(cmax[:, :1], fb_max[:, None]),
            torch.maximum(cmax[:, :-1], cmax[:, 1:]),
            torch.maximum(cmax[:, -1:], ft_max[:, None]),
        ], dim=1)                                 # (nv, nz+1, k)
        qmin = torch.cat([
            torch.minimum(cmin[:, :1], fb_min[:, None]),
            torch.minimum(cmin[:, :-1], cmin[:, 1:]),
            torch.minimum(cmin[:, -1:], ft_min[:, None]),
        ], dim=1)
        if self._has_bnd:
            # lateral walls: per-layer boundary-facet means
            f1 = u[self.bnd_cell, self.bnd_n1]    # (nf, nz, 2, k)
            f2 = u[self.bnd_cell, self.bnd_n2]
            fmean = 0.25 * (f1 + f2).sum(dim=-2)  # (nf, nz, k)
            fm_v = fmean.reshape(-1, nz * k)[self.v2f]  # (nv, KB, nz k)
            big = torch.finfo(u.dtype).max
            mask = self.v2f_mask[:, None, None]
            fmax = torch.where(mask, fm_v, -big).amax(dim=1).reshape(
                nv, nz, k)
            fmin = torch.where(mask, fm_v, big).amin(dim=1).reshape(nv, nz, k)
            bmax = torch.cat([fmax[:, :1],
                              torch.maximum(fmax[:, :-1], fmax[:, 1:]),
                              fmax[:, -1:]], dim=1)
            bmin = torch.cat([fmin[:, :1],
                              torch.minimum(fmin[:, :-1], fmin[:, 1:]),
                              fmin[:, -1:]], dim=1)
            qmax = torch.maximum(qmax, bmax)
            qmin = torch.minimum(qmin, bmin)
        # [qmax_l, qmax_{l+1}, qmin_l, qmin_{l+1}] per (vertex, layer),
        # gathered once per (cell, node, layer)
        Q = torch.cat([qmax[:, :nz], qmax[:, 1:], qmin[:, :nz], qmin[:, 1:]],
                      dim=-1).reshape(nv * nz, 4 * k)
        g = Q[self.layer_idx]                     # (nc, 3, nz, 4k)
        vmax = torch.stack([g[..., :k], g[..., k:2 * k]], dim=-2)
        vmin = torch.stack([g[..., 2 * k:3 * k], g[..., 3 * k:]], dim=-2)
        cb = centroid[:, None, :, None, :]
        dev = u - cb
        eps = 1e-14
        up = torch.where(dev > eps, (vmax - cb) / torch.clamp_min(dev, eps),
                         1.0)
        dn = torch.where(dev < -eps, (vmin - cb) / torch.clamp_max(dev, -eps),
                         1.0)
        alpha = torch.clamp(torch.minimum(up, dn), 0.0, 1.0).amin(dim=(1, 3))
        return cb + alpha[:, None, :, None, :] * dev

    def apply(self, u):
        """Limit a (nc, 3, nz, 2[, k]) dof tensor (each component on its
        own)."""
        if u.dim() == 5:
            return self._apply_multi(u)
        return self._apply_multi(u[..., None])[..., 0]
