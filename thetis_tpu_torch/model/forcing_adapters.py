r"""Concrete data-source forcing adapters.

Re-implementation of the reference's format-specific readers (ref
``forcing.py:82-783``): the generic machinery (time search, linear time
interpolation, scattered/regular-grid spatial interpolation, bulk wind
stress) lives in :mod:`thetis_tpu_torch.model.forcing` /
:mod:`thetis_tpu_torch.utils.interpolation`; this module pins down the file
conventions of each supported product — variable names, grid layouts,
land masks, vertical coordinates and file-name patterns:

  ERA5Interpolator            (ref L172-190)  u10/v10/msl on a regular
                              lat-lon grid, 'valid_time' axis, Pa
  TCHazardsInterpolator       (ref L191-215)  Uw/Vw/Pr daily forecast
                              files from the TCHazaRds package
  SpatialInterpolatorNCOM2d/3d (ref L276-525) NCOM grids: model_lat/
                              model_lon/model_zm.nc + X_Index/Y_Index
                              subsetting, masked land, nearest-fill
  NCOMInterpolator            (ref L526-754)  per-field daily files
                              (s3d/t3d/u3d/v3d/ssh), velocity rotation
  SpatialInterpolatorROMS3d / LiveOceanInterpolator (ref L638-783)
                              ROMS s-coordinates (transformation 2) on
                              the rho grid, 'ocean_time' axis

All adapters accept plain (n, 2)/(n, 3) target coordinate arrays (mesh
node (lon, lat)[, z]); ``fields`` entries are anything with a settable
``.data`` (the port's Functions) or plain dict outputs.

Copied from ``thetis_tpu/model/forcing_adapters.py`` (numpy and scipy on
the host) but for ``_set_field``, which puts the values on the field's
device, in its dtype.
"""
import glob
import os
import re

import numpy as np
import torch

from ..utils.netcdf_io import NCFile, NetCDFTimeSearch
from ..utils.interpolation import (
    GridInterpolator, DailyFileTimeSearch, LinearTimeInterpolator,
)
from .forcing import ATMNetCDFInterpolator

__all__ = [
    "ERA5Interpolator",
    "TCHazardsInterpolator",
    "SpatialInterpolatorNCOM2d",
    "SpatialInterpolatorNCOM3d",
    "NCOMInterpolator",
    "SpatialInterpolatorROMS3d",
    "LiveOceanInterpolator",
]


def _set_field(field, values):
    """Assign interpolated values into a Function-like (settable
    ``.data``: a tensor on the field's device, in its dtype) or return
    them unchanged."""
    if field is None:
        return values
    if hasattr(field, "data"):
        old = field.data
        field.data = torch.as_tensor(
            np.asarray(values), dtype=old.dtype,
            device=old.device).reshape(old.shape)
        return field
    raise TypeError(f"cannot assign forcing into {type(field)}")


class ERA5Interpolator(ATMNetCDFInterpolator):
    """ERA5 atmospheric forcing (ref ``forcing.py:172-190``): wind at
    10 m (``u10``/``v10``) and mean-sea-level pressure (``msl``, Pa) on
    a regular (descending-latitude) lon-lat grid with a ``valid_time``
    (or legacy ``time``) axis.  Wind is converted to stress with the
    bulk formulae and optionally rotated into mesh coordinates.

    :arg target_lonlat: (n, 2) mesh node (lon, lat)
    :arg ncfile_pattern: glob pattern of ERA5 files
    :arg init_date: timezone-aware simulation start datetime
    :kwarg wind_stress_field / atm_pressure_field: optional Function
        targets updated in place by :meth:`set_fields`
    :kwarg coord_system: optional
        :class:`~thetis_tpu_torch.utils.coordsys.UTMCoordinateSystem` used to
        rotate the ENU stress into mesh coordinates
    """

    def __init__(self, target_lonlat, ncfile_pattern, init_date,
                 wind_stress_field=None, atm_pressure_field=None,
                 coord_system=None, pressure_units="pa",
                 east_wind_var_name="u10", north_wind_var_name="v10",
                 pressure_var_name="msl", time_var_name=None, **kw):
        files = sorted(glob.glob(ncfile_pattern))
        if files:
            with NCFile(files[0]) as d:
                if time_var_name is None:
                    # modern ERA5 uses 'valid_time'; older files 'time'
                    time_var_name = ("valid_time"
                                     if "valid_time" in d.variables
                                     else "time")
                # ERA5 ships 'longitude'/'latitude' axes; accept the
                # short names too
                if "lon_name" not in kw:
                    kw["lon_name"] = ("longitude"
                                      if "longitude" in d.variables
                                      else "lon")
                if "lat_name" not in kw:
                    kw["lat_name"] = ("latitude"
                                      if "latitude" in d.variables
                                      else "lat")
        elif time_var_name is None:
            time_var_name = "time"
        super().__init__(
            target_lonlat, ncfile_pattern, init_date,
            var_names={"uwind": east_wind_var_name,
                       "vwind": north_wind_var_name,
                       "prmsl": pressure_var_name},
            time_name=time_var_name, **kw)
        self.pressure_units = str(pressure_units).lower()
        self.wind_stress_field = wind_stress_field
        self.atm_pressure_field = atm_pressure_field
        self._rotator = None
        if coord_system is not None:
            lon = self.target[:, 0]
            lat = self.target[:, 1]
            self._rotator = coord_system.get_vector_rotator(lon, lat)

    def set_fields(self, t):
        out = super().set_fields(t)
        if self.pressure_units == "hpa":
            out["atmospheric_pressure"] = out["atmospheric_pressure"] * 100.0
        if self._rotator is not None:
            tx, ty = self._rotator(out["wind_stress"][:, 0],
                                   out["wind_stress"][:, 1])
            out["wind_stress"] = np.stack([tx, ty], axis=-1)
        _set_field(self.wind_stress_field, out["wind_stress"])
        _set_field(self.atm_pressure_field, out["atmospheric_pressure"])
        return out


class TCHazardsInterpolator(ERA5Interpolator):
    """Atmospheric forcing from the TCHazaRds parametric tropical
    cyclone package (ref ``forcing.py:191-215``): daily forecast files
    with ``Uw``/``Vw`` wind components and ``Pr`` pressure (hPa)."""

    def __init__(self, target_lonlat, ncfile_pattern, init_date, **kw):
        kw.setdefault("east_wind_var_name", "Uw")
        kw.setdefault("north_wind_var_name", "Vw")
        kw.setdefault("pressure_var_name", "Pr")
        kw.setdefault("time_var_name", "time")
        kw.setdefault("pressure_units", "hpa")
        super().__init__(target_lonlat, ncfile_pattern, init_date, **kw)


# ====================== NCOM ==========================================

class _SpatialInterpolatorNCOMBase:
    """NCOM grid handling (ref ``forcing.py:276-372``): the model grid
    lives in side files ``model_lat.nc``/``model_lon.nc``/
    ``model_zm.nc``; data files carry ``X_Index``/``Y_Index`` into the
    global grid and masked land values.  The interpolator subsets the
    grid to a bounding box around the target points (plus the nearest
    valid neighbour of every target, for nearest-fill robustness)."""

    def __init__(self, target_latlonz, grid_path):
        self.latlonz_array = np.asarray(target_latlonz, dtype=float)
        self.grid_path = grid_path
        self._initialized = False

    def _get_forcing_grid(self, filename, varname):
        with NCFile(os.path.join(self.grid_path, filename)) as d:
            return np.asarray(d.variables[varname][:], dtype=float)

    @staticmethod
    def _masked(vals, fill=None):
        """Uniform treatment of netCDF fill values: boolean land mask
        from NaNs / _FillValue-sized entries."""
        vals = np.asarray(vals, dtype=float)
        bad = ~np.isfinite(vals) | (np.abs(vals) > 1e20)
        return vals, bad

    def _create_2d_mapping(self, ncfile):
        lat_full = self._get_forcing_grid("model_lat.nc", "Lat")
        lon_full = self._get_forcing_grid("model_lon.nc", "Long")
        x_ind = np.asarray(ncfile.variables["X_Index"][:], dtype=int)
        y_ind = np.asarray(ncfile.variables["Y_Index"][:], dtype=int)
        lon = lon_full[y_ind, :][:, x_ind]
        lat = lat_full[y_ind, :][:, x_ind]
        varkey = next(k for k in ncfile.variables
                      if k not in ("X_Index", "Y_Index", "level"))
        vals, bad = self._masked(ncfile.variables[varkey][:])
        is3d = vals.ndim == 3
        land_mask = bad.all(axis=0) if is3d else bad

        mask_good = ~land_mask
        mask_cover = np.zeros_like(mask_good)
        buffer = 0.2
        lat_min = self.latlonz_array[:, 0].min() - buffer
        lat_max = self.latlonz_array[:, 0].max() + buffer
        lon_min = self.latlonz_array[:, 1].min() - buffer
        lon_max = self.latlonz_array[:, 1].max() + buffer
        mask_cover[(lat >= lat_min) & (lat <= lat_max)
                   & (lon >= lon_min) & (lon <= lon_max)] = True
        mask_cover &= mask_good
        # nearest valid neighbour of every target point (nearest-fill)
        from scipy.spatial import cKDTree
        ll = np.vstack([lat[mask_good].ravel(),
                        lon[mask_good].ravel()]).T
        _, ix = cKDTree(ll).query(self.latlonz_array[:, :2])
        ix = np.nonzero(mask_good.ravel())[0][np.unique(ix)]
        a, b = np.unravel_index(ix, lat.shape)
        mask_nn = np.zeros_like(mask_good)
        mask_nn[a, b] = True
        mask = mask_cover | mask_nn

        self.nodes = np.nonzero(mask.ravel())[0]
        self.ind_lat, self.ind_lon = np.unravel_index(
            self.nodes, lat.shape)
        return (lon[self.ind_lat, self.ind_lon],
                lat[self.ind_lat, self.ind_lon], x_ind, y_ind, vals)


class SpatialInterpolatorNCOM3d(_SpatialInterpolatorNCOMBase):
    """3D NCOM field interpolation (ref ``forcing.py:367-456``): the
    vertical grid comes from ``model_zm.nc`` (masked below the sea
    floor), the surface level is nudged up so interpolation covers the
    free surface, and the scattered (lat, lon, z) cloud feeds a
    Delaunay :class:`GridInterpolator` with nearest-fill."""

    def _create_interpolator(self, ncfile):
        lon_sub, lat_sub, x_ind, y_ind, vals = self._create_2d_mapping(
            ncfile)
        vals = vals[:, self.ind_lat, self.ind_lon]
        _, bad = self._masked(vals)
        self.good_mask_3d = ~bad

        zm = self._get_forcing_grid("model_zm.nc", "zm")
        zm = zm[:, y_ind, :][:, :, x_ind]
        grid_z = zm[:, self.ind_lat, self.ind_lon]
        grid_z = np.where(np.isfinite(grid_z) & (np.abs(grid_z) < 1e20),
                          grid_z, -5000.0)
        grid_z[0, :] = 1.5  # nudge the surface above z=0
        nz = grid_z.shape[0]

        grid_lat = np.tile(lat_sub, (nz, 1))[self.good_mask_3d]
        grid_lon = np.tile(lon_sub, (nz, 1))[self.good_mask_3d]
        grid_z = grid_z[self.good_mask_3d]
        pts = np.vstack((grid_lat, grid_lon, grid_z)).T
        self.interpolator = GridInterpolator(
            pts, self.latlonz_array, normalize=True, fill_mode="nearest",
            dont_raise=True)
        self._initialized = True

    def interpolate(self, nc_filename, variable_list, itime):
        with NCFile(nc_filename) as d:
            if not self._initialized:
                self._create_interpolator(d)
            out = []
            for var in variable_list:
                grid_data = np.asarray(
                    d.variables[var][:], dtype=float
                )[:, self.ind_lat, self.ind_lon][self.good_mask_3d]
                out.append(self.interpolator(grid_data))
        return out


class SpatialInterpolatorNCOM2d(_SpatialInterpolatorNCOMBase):
    """2D NCOM field interpolation (ref ``forcing.py:457-525``), e.g.
    sea surface height."""

    def _create_interpolator(self, ncfile):
        lon_sub, lat_sub, _, _, vals = self._create_2d_mapping(ncfile)
        pts = np.vstack((lat_sub, lon_sub)).T
        self.interpolator = GridInterpolator(
            pts, self.latlonz_array[:, :2], normalize=True,
            fill_mode="nearest", dont_raise=True)
        self._initialized = True

    def interpolate(self, nc_filename, variable_list, itime):
        with NCFile(nc_filename) as d:
            if not self._initialized:
                self._create_interpolator(d)
            out = []
            for var in variable_list:
                grid_data = np.asarray(
                    d.variables[var][:], dtype=float
                ).reshape(-1)[self.nodes]
                out.append(self.interpolator(grid_data))
        return out


class NCOMInterpolator:
    """NCOM ocean-model forcing over daily per-field files (ref
    ``forcing.py:526-754``): file layout
    ``{basedir}/{year}/{fieldstr}/{fieldstr}.glb8_2f_{YYYYMMDD}00.nc``
    with 'ssh' on the 2D grid and s3d/t3d/u3d/v3d on the 3D grid;
    velocities are rotated from the geographic frame into mesh
    coordinates when both components are requested.

    :arg target_latlonz: (n, 3) 3D target (lat, lon, z)
    :arg target_latlon_2d: (m, 2) 2D target (lat, lon)
    :arg fields: dict mapping netCDF variable name -> Function-like
        (or None to just return arrays)
    :arg field_fnstr: dict mapping variable name -> file field string
        (e.g. {'Salinity': 's3d', 'Surface_Elevation': 'ssh'})
    :arg coord_system: for velocity rotation
    """

    def __init__(self, target_latlonz, target_latlon_2d, fields,
                 field_fnstr, basedir, file_pattern, init_date,
                 coord_system=None):
        self.fields = dict(fields)
        self.field_fnstr = dict(field_fnstr)
        self.grid_interpolator_2d = SpatialInterpolatorNCOM2d(
            np.asarray(target_latlon_2d, dtype=float), basedir)
        self.grid_interpolator_3d = SpatialInterpolatorNCOM3d(
            np.asarray(target_latlonz, dtype=float), basedir)
        from ..utils.timezone import datetime_to_epoch, FixedTimeZone
        t0_epoch = datetime_to_epoch(init_date)

        def stamp(fname):
            """Epoch time parsed from the NCOM filename timestamp
            (…glb8_2f_YYYYMMDDHH.nc), relative to init_date."""
            import datetime as _dt
            m = re.search(r"(\d{10})", os.path.basename(fname))
            assert m, f"no YYYYMMDDHH timestamp in {fname}"
            d = _dt.datetime.strptime(m.group(1), "%Y%m%d%H").replace(
                tzinfo=FixedTimeZone(0, "UTC"))
            return datetime_to_epoch(d) - t0_epoch

        self.time_interpolator = {}
        for ncvarname, fnstr in self.field_fnstr.items():
            gi = (self.grid_interpolator_2d if fnstr == "ssh"
                  else self.grid_interpolator_3d)
            pat = file_pattern.replace("{fieldstr:}", fnstr)
            pat = os.path.join(basedir, pat)
            # the reference formats {year:04d}… per date; glob instead
            pat_glob = re.sub(r"\{[^}]*\}", "*", pat)
            ts = DailyFileTimeSearch(pat_glob, stamp)

            def reader(filename, index, gi=gi, var=ncvarname):
                return gi.interpolate(filename, [var], index)[0]

            self.time_interpolator[ncvarname] = LinearTimeInterpolator(
                ts, reader)
        self.rotate_velocity = ("U_Velocity" in self.field_fnstr
                                and "V_Velocity" in self.field_fnstr)
        if self.rotate_velocity and coord_system is not None:
            lat = self.grid_interpolator_3d.latlonz_array[:, 0]
            lon = self.grid_interpolator_3d.latlonz_array[:, 1]
            self.vect_rotator = coord_system.get_vector_rotator(lon, lat)
        else:
            self.vect_rotator = None

    def set_fields(self, time):
        out = {}
        names = list(self.field_fnstr)
        if self.rotate_velocity:
            u = self.time_interpolator["U_Velocity"](time)
            v = self.time_interpolator["V_Velocity"](time)
            if self.vect_rotator is not None:
                u, v = self.vect_rotator(u, v)
            out["U_Velocity"] = _set_field(self.fields.get("U_Velocity"), u)
            out["V_Velocity"] = _set_field(self.fields.get("V_Velocity"), v)
            names = [n for n in names
                     if n not in ("U_Velocity", "V_Velocity")]
        for name in names:
            vals = self.time_interpolator[name](time)
            out[name] = _set_field(self.fields.get(name), vals)
        return out


# ====================== ROMS / LiveOcean ==============================

class SpatialInterpolatorROMS3d:
    """ROMS output interpolation on the rho grid (ref
    ``forcing.py:620-713``): ``lat_rho``/``lon_rho`` coordinates,
    ``mask_rho`` land mask, and the vertical coordinate reconstructed
    from the s-coordinate parameters (``Cs_w``, ``s_w``, ``hc``, ``h``;
    ROMS transformation 2 evaluated at a constant small free surface)."""

    def __init__(self, target_latlonz):
        self.latlonz_array = np.asarray(target_latlonz, dtype=float)
        self._initialized = False

    def _compute_roms_z_coord(self, ncfile, constant_zeta=None):
        bath = np.asarray(ncfile.variables["h"][:], dtype=float)
        cs = np.asarray(ncfile.variables["Cs_w"][:], dtype=float)
        s = np.asarray(ncfile.variables["s_w"][:], dtype=float)
        hc = float(np.asarray(ncfile.variables["hc"][:]).reshape(-1)[0])
        bath = bath[self.ind_lat, self.ind_lon][self.mask]
        zeta = (np.full_like(bath, constant_zeta)
                if constant_zeta is not None else np.zeros_like(bath))
        ss = (hc * s[:, None] + bath[None, :] * cs[:, None]) \
            / (hc + bath[None, :])
        z_w = zeta[None, :] * (1 + ss) + bath[None, :] * ss
        grid_z = 0.5 * (z_w[1:, :] + z_w[:-1, :])
        grid_z[0, :] = z_w[0, :]
        grid_z[-1, :] = z_w[-1, :]
        return grid_z

    def _create_interpolator(self, ncfile):
        lat = np.asarray(ncfile.variables["lat_rho"][:], dtype=float)
        lon = np.asarray(ncfile.variables["lon_rho"][:], dtype=float)
        mask = np.asarray(ncfile.variables["mask_rho"][:]).astype(bool)
        # subset to a bounding box around the target points
        buffer = 0.2
        lat_t, lon_t = self.latlonz_array[:, 0], self.latlonz_array[:, 1]
        sel = ((lat >= lat_t.min() - buffer) & (lat <= lat_t.max() + buffer)
               & (lon >= lon_t.min() - buffer)
               & (lon <= lon_t.max() + buffer))
        self.nodes = np.nonzero(sel.ravel())[0]
        self.ind_lat, self.ind_lon = np.unravel_index(self.nodes,
                                                      lat.shape)
        lat_sub = lat[self.ind_lat, self.ind_lon]
        lon_sub = lon[self.ind_lat, self.ind_lon]
        self.mask = mask[self.ind_lat, self.ind_lon]
        grid_z = self._compute_roms_z_coord(ncfile, constant_zeta=0.1)
        lat_sub = lat_sub[self.mask]
        lon_sub = lon_sub[self.mask]
        nz = grid_z.shape[0]
        grid_lat = np.tile(lat_sub, (nz, 1)).ravel()
        grid_lon = np.tile(lon_sub, (nz, 1)).ravel()
        pts = np.vstack((grid_lat, grid_lon, grid_z.ravel())).T
        self.interpolator = GridInterpolator(
            pts, self.latlonz_array, normalize=True, fill_mode="nearest",
            dont_raise=True)
        self._initialized = True

    def interpolate(self, nc_filename, variable_list, itime):
        with NCFile(nc_filename) as d:
            if not self._initialized:
                self._create_interpolator(d)
            out = []
            for var in variable_list:
                data = np.asarray(d.variables[var][itime],
                                  dtype=float)
                data = data[:, self.ind_lat, self.ind_lon][:, self.mask]
                out.append(self.interpolator(data.ravel()))
        return out


class LiveOceanInterpolator:
    """LiveOcean (ROMS) forcing over an 'ocean_time' file series (ref
    ``forcing.py:755-783``): temperature/salinity (or any rho-grid
    variables) interpolated onto 3D mesh points for boundary nudging.

    :arg target_latlonz: (n, 3) target (lat, lon, z)
    :arg fields: dict variable name -> Function-like (or None)
    """

    def __init__(self, target_latlonz, fields, ncfile_pattern, init_date):
        self.fields = dict(fields)
        self.grid_interpolator = SpatialInterpolatorROMS3d(
            np.asarray(target_latlonz, dtype=float))
        names = list(self.fields)
        self.timesearch_obj = NetCDFTimeSearch(
            ncfile_pattern, init_date=init_date,
            time_variable_name="ocean_time")

        def reader(filename, index):
            vals = self.grid_interpolator.interpolate(filename, names,
                                                      index)
            return dict(zip(names, vals))

        self.time_interpolator = LinearTimeInterpolator(
            self.timesearch_obj, reader)

    def set_fields(self, time):
        vals = self.time_interpolator(time)
        out = {}
        for name, f in self.fields.items():
            out[name] = (vals[name] if f is None
                         else _set_field(f, vals[name]))
        return out
