r"""Atmospheric and tidal forcing.

Re-implementation of ``thetis/forcing.py`` (SURVEY.md section 2.7):

  Wind stress bulk formulae (ref L19-79):
    - Large & Yeager (2009) with stability-free neutral drag + iteration
    - Large & Pond (1981) simple piecewise drag
  ATMNetCDFTime / interpolators (ref L82-275): generic spatial+temporal
    interpolation of pressure/wind fields onto the mesh (host side,
    building on utils.interpolation)
  TidalBoundaryForcing (ref L951-1160): harmonic tidal elevation at open
    boundaries.  The reference reads TPXO/FES2004 netCDF constituent
    databases via `uptide`; those binary databases are not shipped, so
    constituent amplitudes/phases are supplied by the user (or any loader)
    and the harmonic synthesis (nodal-corrected summation) is done here.

Copied unchanged from ``thetis_tpu/model/forcing.py`` (numpy and scipy on
the host); a caller sets the results into a model field, whose tensor
they then join on its device (``forcing_adapters._set_field``).
"""
import numpy as np

from ..config import physical_constants

__all__ = [
    "compute_wind_stress",
    "smooth_wind_stress",
    "TidalBoundaryForcing",
    "TPXOTidalBoundaryForcing",
    "FES2004TidalBoundaryForcing",
    "GenericNetCDFInterpolator2D",
    "Ocean3DInterpolator",
    "ATMInterpolator",
    "ATMNetCDFInterpolator",
    "CONSTITUENT_FREQUENCIES",
]


def compute_wind_stress(wind_u, wind_v, method="LargeYeager2009"):
    """Wind stress from 10-m wind (ref ``forcing.py:19-79``).

    :returns: (tau_x, tau_y) in Pa
    """
    rho_air = physical_constants["rho_air"]
    wind_u = np.asarray(wind_u, dtype=float)
    wind_v = np.asarray(wind_v, dtype=float)
    wind_mag = np.hypot(wind_u, wind_v)
    if method == "LargePond1981":
        # piecewise drag coefficient (L&P 1981, eq. 19)
        Cd = np.where(wind_mag <= 11.0, 1.2e-3,
                      1e-3 * (0.49 + 0.065 * wind_mag))
    elif method == "LargeYeager2009":
        # neutral 10-m drag (L&Y 2009, eq. 11), iterated once
        eps = 1e-12
        U = np.maximum(wind_mag, 0.5)
        Cd = 1e-3 * (2.7 / (U + eps) + 0.142 + U / 13.09)
    else:
        raise ValueError(f"unknown wind stress method {method}")
    tau = rho_air * Cd * wind_mag
    return tau * wind_u, tau * wind_v


def smooth_wind_stress(tau_x, tau_y, ramp=1.0):
    return ramp * np.asarray(tau_x), ramp * np.asarray(tau_y)


#: Principal tidal constituent angular frequencies (rad/s), standard
#: Doodson values (public astronomical constants).
CONSTITUENT_FREQUENCIES = {
    "M2": 1.405189e-4,
    "S2": 1.454441e-4,
    "N2": 1.378797e-4,
    "K2": 1.458423e-4,
    "K1": 7.292117e-5,
    "O1": 6.759774e-5,
    "P1": 7.252295e-5,
    "Q1": 6.495854e-5,
    "Mf": 0.053234e-4,
    "Mm": 0.026392e-4,
    "M4": 2.810377e-4,
}


class TidalBoundaryForcing:
    r"""Harmonic tidal elevation at boundary nodes
    (ref ``forcing.py:951-1160``):

      eta(t) = sum_c f_c A_c cos(omega_c t + phi_c + u_c)

    :arg amplitudes: {constituent: (n_pts,) amplitude [m]}
    :arg phases: {constituent: (n_pts,) phase [rad]}

    The reference obtains (A, phi) per boundary node from the TPXO or
    FES2004 databases through `uptide`; any loader producing the same
    dicts plugs in here.  Nodal corrections (f, u) default to 1/0 and may
    be supplied per constituent.
    """

    def __init__(self, amplitudes, phases, constituents=None,
                 nodal_factors=None, nodal_phases=None, initial_time=0.0):
        self.constituents = constituents or sorted(amplitudes)
        for c in self.constituents:
            assert c in CONSTITUENT_FREQUENCIES, f"unknown constituent {c}"
        self.amplitudes = {c: np.asarray(amplitudes[c], dtype=float)
                           for c in self.constituents}
        self.phases = {c: np.asarray(phases[c], dtype=float)
                       for c in self.constituents}
        self.nodal_factors = nodal_factors or {}
        self.nodal_phases = nodal_phases or {}
        self.initial_time = initial_time

    def set_tidal_field(self, t):
        """Elevation at the boundary nodes at simulation time ``t``."""
        t_abs = self.initial_time + t
        eta = 0.0
        for c in self.constituents:
            om = CONSTITUENT_FREQUENCIES[c]
            f = self.nodal_factors.get(c, 1.0)
            u = self.nodal_phases.get(c, 0.0)
            eta = eta + f * self.amplitudes[c] * np.cos(
                om * t_abs - self.phases[c] + u
            )
        return eta


class TPXOTidalBoundaryForcing:
    """File-driven tidal boundary forcing in the TPXO/OTPS netCDF format
    (ref ``forcing.py:1086-1143`` ``TPXOTidalBoundaryForcing``).

    Reads per-constituent complex elevation grids (variables ``hRe`` /
    ``hIm`` over ``lon_z`` / ``lat_z``, constituent names in ``con``),
    bilinearly interpolates them to the supplied boundary-node
    coordinates, and synthesizes the nodal-corrected harmonic signal with
    :class:`thetis_tpu_torch.utils.tides.Tides` (the ``uptide`` analogue).

    :arg latlon: (n, 2) array of (lat, lon) boundary-node coordinates
    :arg init_date: timezone-aware datetime of simulation t=0
    :kwarg constituents: subset to use (default: all found in the file)
    :kwarg data_dir: directory containing ``elev_file``
    """

    coord_layout = "lon,lat"

    def __init__(self, latlon, init_date, constituents=None, data_dir="",
                 elev_file="h_tpxo9.v5a.nc"):
        import os
        from scipy.interpolate import RegularGridInterpolator
        from ..utils.netcdf_io import NCFile
        from ..utils.tides import Tides

        path = os.path.join(data_dir, elev_file)
        assert os.path.exists(path), f"File {path} not found."
        latlon = np.asarray(latlon, dtype=float)
        lat, lon = latlon[:, 0], latlon[:, 1]
        with NCFile(path) as d:
            con_raw = d.variables["con"][:]
            if con_raw.dtype.kind in "SU":
                names = ["".join(
                    c.decode() if isinstance(c, bytes) else str(c)
                    for c in row).strip().upper() for row in con_raw]
            else:
                names = [str(c).strip().upper() for c in con_raw]
            lon_z = np.asarray(d.variables["lon_z"][:], dtype=float)
            lat_z = np.asarray(d.variables["lat_z"][:], dtype=float)
            if lon_z.ndim == 2:  # OTPS stores full 2D grids
                lon_ax = lon_z[:, 0] if np.allclose(
                    lon_z[:, 0], lon_z[:, -1]) else lon_z[0, :]
                lat_ax = lat_z[0, :] if np.allclose(
                    lat_z[0, :], lat_z[-1, :]) else lat_z[:, 0]
            else:
                lon_ax, lat_ax = lon_z, lat_z
            h_re = np.asarray(d.variables["hRe"][:], dtype=float)
            h_im = np.asarray(d.variables["hIm"][:], dtype=float)
        # match the file's longitude convention (TPXO uses 0..360;
        # regional extracts may use -180..180)
        if lon_ax.max() > 180.0:
            lon = lon % 360.0
        else:
            lon = (lon + 180.0) % 360.0 - 180.0
        if constituents is not None:
            wanted = [c.upper() for c in constituents]
            missing = set(wanted) - set(names)
            assert not missing, f"constituents not in {path}: {missing}"
            sel = [names.index(c) for c in wanted]
            names = wanted
            h_re, h_im = h_re[sel], h_im[sel]
        self.constituents = names
        # bilinear interpolation of each constituent's complex amplitude
        # to the boundary nodes; the hRe/hIm grids are (ncon, nlon, nlat)
        pts = np.stack([lon, lat], axis=-1)
        n = latlon.shape[0]
        self.h_re = np.empty((n, len(names)))
        self.h_im = np.empty((n, len(names)))
        for i in range(len(names)):
            for dst, grid in ((self.h_re, h_re[i]), (self.h_im, h_im[i])):
                itp = RegularGridInterpolator(
                    (lon_ax, lat_ax), grid, bounds_error=False,
                    fill_value=None,
                )
                dst[:, i] = itp(pts)
        self.tide = Tides(names)
        self.tide.set_initial_time(init_date)

    def set_tidal_field(self, t):
        """Elevation (n,) at the boundary nodes at simulation time t."""
        return self.tide.from_complex(self.h_re, self.h_im, t)


class ATMInterpolator:
    """Interpolate atmospheric model fields (pressure, wind) in space and
    time onto mesh dof coordinates (ref ``forcing.py:82-275``).

    :arg target_xy: (n, 2) dof coordinates
    :arg time_interpolator: callable(t) -> dict with keys 'prmsl', 'uwind',
        'vwind' arrays on the source grid
    :arg spatial_interpolator: SpatialInterpolator2d already built for the
        source grid
    """

    def __init__(self, target_xy, spatial_interpolator, time_interpolator,
                 wind_stress_method="LargeYeager2009"):
        self.spatial = spatial_interpolator
        self.temporal = time_interpolator
        self.method = wind_stress_method

    def set_fields(self, t, src_lon, src_lat):
        data = self.temporal(t)
        prmsl = self.spatial.interpolate(src_lon, src_lat, data["prmsl"])
        uwind = self.spatial.interpolate(src_lon, src_lat, data["uwind"])
        vwind = self.spatial.interpolate(src_lon, src_lat, data["vwind"])
        tau_x, tau_y = compute_wind_stress(uwind, vwind, self.method)
        return dict(atmospheric_pressure=prmsl,
                    wind_stress=np.stack([tau_x, tau_y], axis=-1))


class ATMNetCDFInterpolator:
    """File-driven atmospheric forcing: wind and mean-sea-level pressure
    read from a netCDF file tree with a CF time axis, interpolated in
    space (regular lat-lon grid, bilinear) and time (linear) onto mesh
    node coordinates, wind converted to stress with the bulk formulae
    (ref ``ATMNetCDFTime`` + ``ATMInterpolator``/``ERA5Interpolator``,
    ``forcing.py:82-275``).

    :arg target_lonlat: (n, 2) mesh node (lon, lat)
    :arg ncfile_pattern: glob pattern of forcing files
    :arg init_date: timezone-aware datetime of simulation t=0
    :kwarg var_names: netCDF variable names, default ERA5-style
        ``{'uwind': 'u10', 'vwind': 'v10', 'prmsl': 'msl'}``
    """

    def __init__(self, target_lonlat, ncfile_pattern, init_date,
                 var_names=None, lon_name="lon", lat_name="lat",
                 wind_stress_method="LargeYeager2009", time_name="time"):
        from scipy.interpolate import RegularGridInterpolator
        from ..utils.netcdf_io import NCFile, NetCDFTimeSearch
        from ..utils.interpolation import LinearTimeInterpolator

        self.vars = var_names or {
            "uwind": "u10", "vwind": "v10", "prmsl": "msl"
        }
        self.method = wind_stress_method
        self.target = np.asarray(target_lonlat, dtype=float)
        self.timesearch = NetCDFTimeSearch(ncfile_pattern,
                                           init_date=init_date,
                                           time_variable_name=time_name)
        with NCFile(self.timesearch.files[0]) as d:
            self.lon_ax = np.asarray(d.variables[lon_name][:], dtype=float)
            self.lat_ax = np.asarray(d.variables[lat_name][:], dtype=float)
        self._rgi = RegularGridInterpolator  # bound for reader closures

        def reader(filename, index):
            with NCFile(filename) as d:
                return {k: np.asarray(d.variables[v][index], dtype=float)
                        for k, v in self.vars.items()}

        self.time_interp = LinearTimeInterpolator(self.timesearch, reader)

    def _to_mesh(self, grid_vals):
        # grids may be (lat, lon) or (lon, lat); detect from shape
        if grid_vals.shape == (len(self.lat_ax), len(self.lon_ax)):
            axes, pts = (self.lat_ax, self.lon_ax), self.target[:, ::-1]
        else:
            axes, pts = (self.lon_ax, self.lat_ax), self.target
        # descending axes (ERA5 latitude) need flipping
        ax0, ax1 = axes
        vals = grid_vals
        if ax0[0] > ax0[-1]:
            ax0, vals = ax0[::-1], vals[::-1]
        if ax1[0] > ax1[-1]:
            ax1, vals = ax1[::-1], vals[:, ::-1]
        itp = self._rgi((ax0, ax1), vals, bounds_error=False,
                        fill_value=None)
        return itp(pts)

    def set_fields(self, t):
        """Interpolated forcing at simulation time ``t`` (seconds):
        returns dict with ``wind_stress`` (n, 2) and
        ``atmospheric_pressure`` (n,)."""
        data = self.time_interp(t)
        uwind = self._to_mesh(np.asarray(data["uwind"]))
        vwind = self._to_mesh(np.asarray(data["vwind"]))
        prmsl = self._to_mesh(np.asarray(data["prmsl"]))
        tau_x, tau_y = compute_wind_stress(uwind, vwind, self.method)
        return dict(atmospheric_pressure=prmsl,
                    wind_stress=np.stack([tau_x, tau_y], axis=-1))


class FES2004TidalBoundaryForcing:
    """File-driven tidal boundary forcing in the FES2004 netCDF format
    (ref ``forcing.py:1146-1160``): per-constituent amplitude (``Ha``,
    cm) and Greenwich phase lag (``Hg``, degrees) grids over
    latitude/longitude (``coord_layout = 'lat,lon'``), synthesised with
    nodal corrections by :class:`thetis_tpu_torch.utils.tides.Tides`.

    :arg latlon: (n, 2) array of (lat, lon) boundary-node coordinates
    :arg init_date: timezone-aware datetime of simulation t=0
    """

    coord_layout = "lat,lon"
    compute_velocity = False

    def __init__(self, latlon, init_date, constituents=None, data_dir="",
                 elev_file="tide.fes2004.nc"):
        import os
        from scipy.interpolate import RegularGridInterpolator
        from ..utils.netcdf_io import NCFile
        from ..utils.tides import Tides

        path = os.path.join(data_dir, elev_file)
        assert os.path.exists(path), (
            f"File {path} not found, download it from "
            "ftp://ftp.legos.obs-mip.fr/pub/soa/maree/tide_model/"
            "global_solution/fes2004/"
        )
        latlon = np.asarray(latlon, dtype=float)
        lat = latlon[:, 0]
        with NCFile(path) as d:
            names = None
            for key in ("spectrum", "con", "constituents"):
                if key in d.variables:
                    raw = d.variables[key][:]
                    names = ["".join(
                        c.decode() if isinstance(c, bytes) else str(c)
                        for c in row).strip().upper() for row in raw]
                    break
            assert names is not None, f"no constituent names in {path}"
            lat_ax = lon_ax = None
            for key in ("lat", "latitude"):
                if key in d.variables:
                    lat_ax = np.asarray(d.variables[key][:], dtype=float)
            for key in ("lon", "longitude"):
                if key in d.variables:
                    lon_ax = np.asarray(d.variables[key][:], dtype=float)
            amp = np.asarray(d.variables["Ha"][:], dtype=float)  # cm
            pha = np.asarray(d.variables["Hg"][:], dtype=float)  # deg
        lon = latlon[:, 1] % 360.0 if lon_ax.max() > 180.0 else (
            (latlon[:, 1] + 180.0) % 360.0 - 180.0)
        if constituents is not None:
            wanted = [c.upper() for c in constituents]
            missing = set(wanted) - set(names)
            assert not missing, f"constituents not in {path}: {missing}"
            sel = [names.index(c) for c in wanted]
            names = wanted
            amp, pha = amp[sel], pha[sel]
        self.constituents = names
        pts = np.stack([lat, lon], axis=-1)  # lat,lon layout
        n = latlon.shape[0]
        self.amplitudes = np.empty((n, len(names)))
        self.phases = np.empty((n, len(names)))
        for i in range(len(names)):
            a_itp = RegularGridInterpolator(
                (lat_ax, lon_ax), amp[i], bounds_error=False,
                fill_value=None)
            # interpolate phase through the complex plane (wraparound-safe)
            re = RegularGridInterpolator(
                (lat_ax, lon_ax), np.cos(np.deg2rad(pha[i])),
                bounds_error=False, fill_value=None)
            im = RegularGridInterpolator(
                (lat_ax, lon_ax), np.sin(np.deg2rad(pha[i])),
                bounds_error=False, fill_value=None)
            self.amplitudes[:, i] = a_itp(pts) * 0.01  # cm -> m
            self.phases[:, i] = np.arctan2(im(pts), re(pts))
        from ..utils.tides import Tides as _T

        self.tide = _T(names)
        self.tide.set_initial_time(init_date)

    def set_tidal_field(self, t):
        """Elevation (n,) at the boundary nodes at simulation time t."""
        return self.tide.from_amplitude_phase(
            self.amplitudes, self.phases, t)


class GenericNetCDFInterpolator2D:
    """Interpolate arbitrary 2D netCDF fields (CF latitude/longitude
    axes, linear in time over a file tree) onto mesh node coordinates
    (ref ``GenericSpatialInterpolator2D``/``GenericInterpolator2D``,
    ``forcing.py:784-950``).

    :arg target_lonlat: (n, 2) mesh node (lon, lat)
    :arg ncfile_pattern: glob pattern of input files
    :arg init_date: timezone-aware datetime of simulation t=0
    :arg variables: list of netCDF variable names to extract
    """

    def __init__(self, target_lonlat, ncfile_pattern, init_date, variables,
                 lon_name="lon", lat_name="lat", time_name="time"):
        self._atm = ATMNetCDFInterpolator(
            target_lonlat, ncfile_pattern, init_date,
            var_names={v: v for v in variables},
            lon_name=lon_name, lat_name=lat_name,
        )
        self.variables = list(variables)

    def set_fields(self, t):
        """{name: (n,) interpolated values} at simulation time t."""
        data = self._atm.time_interp(t)
        return {v: self._atm._to_mesh(np.asarray(data[v]))
                for v in self.variables}


class Ocean3DInterpolator:
    """Interpolate 3D ocean-model fields (z-level netCDF: dims
    ``(time, depth, lat, lon)``) onto the 3D solver's node coordinates —
    the NCOM/ROMS-nudging analogue (ref ``NCOMInterpolator`` /
    ``LiveOceanInterpolator``, ``forcing.py:276-783``; ROMS s-coordinate
    files must be pre-converted to z levels).

    :arg target_lonlat: (n, 2) horizontal node (lon, lat)
    :arg ncfile_pattern: glob of forcing files
    :arg init_date: timezone-aware datetime of simulation t=0
    :arg variables: list of 3D variable names (e.g. ['salinity',
        'temperature'])
    :kwarg depth_name: name of the (positive-down) depth axis
    """

    def __init__(self, target_lonlat, ncfile_pattern, init_date, variables,
                 lon_name="lon", lat_name="lat", depth_name="depth",
                 time_name="time"):
        from ..utils.netcdf_io import NCFile, NetCDFTimeSearch
        from ..utils.interpolation import LinearTimeInterpolator

        self.variables = list(variables)
        self.target = np.asarray(target_lonlat, dtype=float)
        self.timesearch = NetCDFTimeSearch(ncfile_pattern,
                                           init_date=init_date,
                                           time_variable_name=time_name)
        with NCFile(self.timesearch.files[0]) as d:
            self.lon_ax = np.asarray(d.variables[lon_name][:], dtype=float)
            self.lat_ax = np.asarray(d.variables[lat_name][:], dtype=float)
            self.z_ax = np.asarray(d.variables[depth_name][:], dtype=float)

        def reader(filename, index):
            with NCFile(filename) as d:
                return {v: np.asarray(d.variables[v][index], dtype=float)
                        for v in self.variables}

        self.time_interp = LinearTimeInterpolator(self.timesearch, reader)

    def set_fields(self, t, z_nodes):
        """Interpolated fields at simulation time ``t`` for the given
        per-node depths ``z_nodes`` (n,), positive down or negative up —
        matched to the file's depth-axis convention automatically.

        :returns: {name: (n,) values}
        """
        from scipy.interpolate import RegularGridInterpolator

        z = np.asarray(z_nodes, dtype=float)
        if self.z_ax.min() >= 0.0:  # positive-down file axis
            z = np.abs(z)
        data = self.time_interp(t)
        pts = np.stack(
            [z, self.target[:, 1], self.target[:, 0]], axis=-1
        )  # (depth, lat, lon)
        out = {}
        for v in self.variables:
            grid = np.asarray(data[v])
            # fill NaNs (land mask) by nearest valid level value
            itp = RegularGridInterpolator(
                (self.z_ax, self.lat_ax, self.lon_ax), grid,
                bounds_error=False, fill_value=None)
            out[v] = itp(pts)
        return out
