r"""Interpolation framework for external data.

Re-implementation of ``thetis/interpolation.py`` (SURVEY.md section 2.7):

  GridInterpolator          (ref L113-241): Delaunay-based linear
      interpolation with precomputed reusable barycentric weights
  SpatialInterpolator2d     (ref L348-478)
  NetCDFTimeSearch / DailyFileTimeSearch (ref L605-766): time search over
      file trees
  LinearTimeInterpolator    (ref L767-825): caching two-slice linear
      interpolation in time
  NetCDFTimeSeriesInterpolator (ref L827-867)

These run host-side at setup/forcing time (not in the jit hot loop), so
they are plain numpy/scipy.  NetCDF readers are gated on netCDF4/h5py
availability (netCDF4 is not in this image; HDF5-based and callable
sources are supported).

Copied unchanged from ``thetis_tpu/utils/interpolation.py`` (numpy and
scipy only).
"""
import glob

import numpy as np

__all__ = [
    "GridInterpolator",
    "SpatialInterpolator2d",
    "LinearTimeInterpolator",
    "TimeSearch",
    "DailyFileTimeSearch",
    "TimeSeriesInterpolator",
]


class GridInterpolator:
    """Linear interpolation from scattered source points to fixed target
    points with precomputed weights (ref L113-241, qhull/Delaunay based).

    :arg grid_xyz: (n_src, dim) source point coordinates
    :arg target_xyz: (n_tgt, dim) target points
    :kwarg fill_mode: None | 'nearest' | constant value for targets
        outside the convex hull
    """

    def __init__(self, grid_xyz, target_xyz, fill_mode=None,
                 fill_value=np.nan, normalize=False, dont_raise=False):
        from scipy.spatial import Delaunay, cKDTree

        grid_xyz = np.asarray(grid_xyz, dtype=float)
        target_xyz = np.asarray(target_xyz, dtype=float)
        self.fill_mode = fill_mode
        self.fill_value = fill_value
        if normalize:
            mean = grid_xyz.mean(axis=0)
            scale = np.maximum(grid_xyz.std(axis=0), 1e-14)
            grid_xyz = (grid_xyz - mean) / scale
            target_xyz = (target_xyz - mean) / scale
        tri = Delaunay(grid_xyz)
        simplex = tri.find_simplex(target_xyz)
        self.outside = simplex < 0
        if self.outside.any() and fill_mode is None and not dont_raise:
            raise ValueError(
                f"{int(self.outside.sum())} target points outside the "
                "source grid; set fill_mode"
            )
        simplex_c = np.maximum(simplex, 0)
        verts = tri.simplices[simplex_c]  # (n_tgt, dim+1)
        X = tri.transform[simplex_c]
        dim = grid_xyz.shape[1]
        bary = np.einsum(
            "nij,nj->ni", X[:, :dim, :], target_xyz - X[:, dim, :]
        )
        self.weights = np.concatenate(
            [bary, (1 - bary.sum(axis=1))[:, None]], axis=1
        )
        self.vertices = verts
        if fill_mode == "nearest":
            tree = cKDTree(grid_xyz)
            _, self.nearest = tree.query(target_xyz[self.outside])

    def __call__(self, values):
        values = np.asarray(values)
        out = np.einsum("ni,ni->n", np.take(values, self.vertices),
                        self.weights)
        if self.outside.any():
            if self.fill_mode == "nearest":
                out[self.outside] = values[self.nearest]
            elif self.fill_mode is not None:
                out[self.outside] = self.fill_mode if not np.isnan(
                    self.fill_value
                ) else self.fill_mode
        return out


class SpatialInterpolator2d:
    """Interpolate source grids onto mesh dof coordinates
    (ref L348-478)."""

    def __init__(self, target_xy, coordsys=None, fill_mode=None):
        self.target_xy = np.asarray(target_xy, dtype=float)
        self.coordsys = coordsys
        self.fill_mode = fill_mode
        self._interp = None

    def _build(self, src_lon, src_lat):
        pts = np.stack(
            [np.asarray(src_lon).ravel(), np.asarray(src_lat).ravel()],
            axis=1,
        )
        tgt = self.target_xy
        if self.coordsys is not None:
            lon, lat = self.coordsys.to_lonlat(tgt[:, 0], tgt[:, 1])
            tgt = np.stack([np.asarray(lon), np.asarray(lat)], axis=1)
        self._interp = GridInterpolator(pts, tgt, fill_mode=self.fill_mode,
                                        normalize=True, dont_raise=True)

    def interpolate(self, src_lon, src_lat, values):
        if self._interp is None:
            self._build(src_lon, src_lat)
        return self._interp(np.asarray(values).ravel())


class TimeSearch:
    """Locate the data slices bracketing a given time over a file tree
    (ref NetCDFTimeSearch, L605-675).  Generic over a user-supplied
    ``time_of(file, index) -> float`` table built at construction."""

    def __init__(self, file_pattern, times_fn):
        """
        :arg file_pattern: glob pattern
        :arg times_fn: callable(file) -> array of epoch times in that file
        """
        self.files = sorted(glob.glob(file_pattern))
        assert self.files, f"no files match {file_pattern}"
        self.file_times = []
        starts = []
        for f in self.files:
            t = np.asarray(times_fn(f), dtype=float)
            self.file_times.append(t)
            starts.append(t[0])
        order = np.argsort(starts)
        self.files = [self.files[i] for i in order]
        self.file_times = [self.file_times[i] for i in order]
        self.start_times = np.asarray([t[0] for t in self.file_times])

    def find(self, time, previous=False):
        """Return (filename, index, time) of the slice at or bracketing
        ``time``."""
        for fi in range(len(self.files) - 1, -1, -1):
            t = self.file_times[fi]
            if time >= t[0] - 1e-6:
                idx = np.searchsorted(t, time + 1e-6) - 1
                if previous:
                    idx = max(idx, 0)
                    return self.files[fi], int(idx), float(t[idx])
                if idx + 1 < len(t):
                    return self.files[fi], int(idx + 1), float(t[idx + 1])
                if fi + 1 < len(self.files):
                    return (self.files[fi + 1], 0,
                            float(self.file_times[fi + 1][0]))
                return self.files[fi], int(idx), float(t[idx])
        f0 = self.files[0]
        return f0, 0, float(self.file_times[0][0])


class DailyFileTimeSearch(TimeSearch):
    """One file per day, date parsed from the filename
    (ref L676-766)."""

    def __init__(self, file_pattern, timestamp_fn):
        """:arg timestamp_fn: callable(filename) -> epoch time of day start"""
        files = sorted(glob.glob(file_pattern))
        assert files, f"no files match {file_pattern}"

        def times_fn(f):
            return [timestamp_fn(f)]

        super().__init__(file_pattern, times_fn)


class LinearTimeInterpolator:
    """Linear interpolation in time with a two-slice cache
    (ref L767-825)."""

    def __init__(self, timesearch, reader):
        """
        :arg timesearch: TimeSearch
        :arg reader: callable(filename, index) -> field array
        """
        self.timesearch = timesearch
        self.reader = reader
        self.cache = {}

    def _get(self, fn, idx):
        key = (fn, idx)
        if key not in self.cache:
            self.cache[key] = self.reader(fn, idx)
            if len(self.cache) > 4:  # keep the cache small (ref L801)
                self.cache.pop(next(iter(self.cache)))
        return self.cache[key]

    def __call__(self, t):
        f0, i0, t0 = self.timesearch.find(t, previous=True)
        f1, i1, t1 = self.timesearch.find(t, previous=False)
        v0 = self._get(f0, i0)
        v1 = self._get(f1, i1)

        def combine(a, b, alpha):
            if isinstance(a, dict):
                return {k: combine(a[k], b[k], alpha) for k in a}
            if isinstance(a, (list, tuple)):
                return type(a)(combine(x, y, alpha) for x, y in zip(a, b))
            return (1 - alpha) * np.asarray(a) + alpha * np.asarray(b)

        if t1 <= t0:
            return combine(v0, v0, 0.0)
        alpha = min(max((t - t0) / (t1 - t0), 0.0), 1.0)
        return combine(v0, v1, alpha)


class TimeSeriesInterpolator:
    """Interpolate a (time, value) series (ref NetCDFTimeSeriesInterpolator
    L827-867) with optional scaling/offset."""

    def __init__(self, times, values, scalars=1.0, offset=0.0,
                 allow_extrapolation=False):
        self.times = np.asarray(times, dtype=float)
        self.values = np.asarray(values, dtype=float)
        self.scalars = scalars
        self.offset = offset
        self.allow_extrapolation = allow_extrapolation

    def __call__(self, t):
        if not self.allow_extrapolation:
            assert self.times[0] <= t <= self.times[-1], \
                f"time {t} outside series range"
        return np.interp(t, self.times, self.values) * self.scalars + self.offset
