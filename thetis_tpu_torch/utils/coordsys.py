r"""Coordinate system utilities.

Re-implementation of ``thetis/coordsys.py``: UTM <-> lat/lon transforms and
local vector rotation.  The reference uses pyproj; this implementation
carries its own standard UTM (transverse Mercator, WGS84) formulas so the
stack has no native PROJ dependency; pyproj is used when available.

Copied unchanged from ``thetis_tpu/utils/coordsys.py`` (numpy / plain Python only).
"""
import numpy as np

__all__ = ["UTMCoordinateSystem", "LL_WGS84", "get_vector_rotator"]

# WGS84 ellipsoid
_A = 6378137.0
_F = 1 / 298.257223563
_E2 = _F * (2 - _F)
_K0 = 0.9996

LL_WGS84 = "EPSG:4326"


def _utm_central_meridian(zone):
    return np.deg2rad(-183.0 + 6.0 * zone)


def lonlat_to_utm(lon, lat, zone):
    """Forward transverse Mercator (accurate series expansion)."""
    lon = np.deg2rad(np.asarray(lon, dtype=float))
    lat = np.deg2rad(np.asarray(lat, dtype=float))
    lam0 = _utm_central_meridian(zone)
    e2 = _E2
    ep2 = e2 / (1 - e2)
    N = _A / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    T = np.tan(lat) ** 2
    C = ep2 * np.cos(lat) ** 2
    Aq = (lon - lam0) * np.cos(lat)
    M = _A * (
        (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256) * lat
        - (3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024) * np.sin(2 * lat)
        + (15 * e2**2 / 256 + 45 * e2**3 / 1024) * np.sin(4 * lat)
        - (35 * e2**3 / 3072) * np.sin(6 * lat)
    )
    x = _K0 * N * (
        Aq + (1 - T + C) * Aq**3 / 6
        + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * Aq**5 / 120
    ) + 500000.0
    y = _K0 * (
        M + N * np.tan(lat) * (
            Aq**2 / 2 + (5 - T + 9 * C + 4 * C**2) * Aq**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * Aq**6 / 720
        )
    )
    y = np.where(lat < 0, y + 10000000.0, y)
    return x, y


def utm_to_lonlat(x, y, zone, northern=True):
    """Inverse transverse Mercator."""
    x = np.asarray(x, dtype=float) - 500000.0
    y = np.asarray(y, dtype=float)
    if not northern:
        y = y - 10000000.0
    e2 = _E2
    ep2 = e2 / (1 - e2)
    e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))
    M = y / _K0
    mu = M / (_A * (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256))
    phi1 = (
        mu + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
        + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
        + (151 * e1**3 / 96) * np.sin(6 * mu)
        + (1097 * e1**4 / 512) * np.sin(8 * mu)
    )
    N1 = _A / np.sqrt(1 - e2 * np.sin(phi1) ** 2)
    T1 = np.tan(phi1) ** 2
    C1 = ep2 * np.cos(phi1) ** 2
    R1 = _A * (1 - e2) / (1 - e2 * np.sin(phi1) ** 2) ** 1.5
    D = x / (N1 * _K0)
    lat = phi1 - (N1 * np.tan(phi1) / R1) * (
        D**2 / 2 - (5 + 3 * T1 + 10 * C1 - 4 * C1**2 - 9 * ep2) * D**4 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1**2 - 252 * ep2 - 3 * C1**2)
        * D**6 / 720
    )
    lon = _utm_central_meridian(zone) + (
        D - (1 + 2 * T1 + C1) * D**3 / 6
        + (5 - 2 * C1 + 28 * T1 - 3 * C1**2 + 8 * ep2 + 24 * T1**2)
        * D**5 / 120
    ) / np.cos(phi1)
    return np.rad2deg(lon), np.rad2deg(lat)


class UTMCoordinateSystem:
    """ref ``coordsys.py:58-127``."""

    def __init__(self, utm_zone, northern=True):
        self.utm_zone = utm_zone
        self.northern = northern
        try:  # prefer pyproj when present
            import pyproj

            self._proj = pyproj.Proj(
                proj="utm", zone=utm_zone, ellps="WGS84",
                south=not northern,
            )
        except Exception:
            self._proj = None

    def to_lonlat(self, x, y, positive_lon=False):
        if self._proj is not None:
            lon, lat = self._proj(x, y, inverse=True)
        else:
            lon, lat = utm_to_lonlat(x, y, self.utm_zone, self.northern)
        if positive_lon:
            lon = np.where(np.asarray(lon) < 0, np.asarray(lon) + 360.0, lon)
        return lon, lat

    def to_xy(self, lon, lat):
        if self._proj is not None:
            return self._proj(lon, lat)
        return lonlat_to_utm(lon, lat, self.utm_zone)

    def get_mesh_lonlat_function(self, mesh2d):
        """lon/lat at mesh vertices."""
        x = mesh2d.coords_np[:, 0]
        y = mesh2d.coords_np[:, 1]
        return self.to_lonlat(x, y)

    def get_vector_rotator(self, lon, lat):
        return get_vector_rotator(self, lon, lat)


def get_vector_rotator(coordsys, lon, lat):
    """Rotate (east, north) vectors to mesh (x, y) components by local
    finite differencing of the projection (ref ``coordsys.py:129-190``)."""
    delta = 1e-5
    x0, y0 = coordsys.to_xy(lon, lat)
    x1, y1 = coordsys.to_xy(np.asarray(lon) + delta, lat)
    x2, y2 = coordsys.to_xy(lon, np.asarray(lat) + delta)
    dxdlon = (np.asarray(x1) - np.asarray(x0)) / delta
    dydlon = (np.asarray(y1) - np.asarray(y0)) / delta
    dxdlat = (np.asarray(x2) - np.asarray(x0)) / delta
    dydlat = (np.asarray(y2) - np.asarray(y0)) / delta
    nrm_lon = np.hypot(dxdlon, dydlon)
    nrm_lat = np.hypot(dxdlat, dydlat)

    def rotator(v_east, v_north):
        vx = v_east * dxdlon / nrm_lon + v_north * dxdlat / nrm_lat
        vy = v_east * dydlon / nrm_lon + v_north * dydlat / nrm_lat
        return vx, vy

    return rotator


def beta_plane_coriolis_params(latitude):
    """f0, beta for a beta-plane approximation at the given latitude in
    degrees (ref ``coordsys.py`` beta_plane_coriolis_params):
    f0 = 2 Omega sin(phi), beta = 2 Omega cos(phi) / R_earth."""
    omega = 7.2921150e-5  # Earth's angular velocity (rad/s)
    r_earth = 6371.0e3    # mean Earth radius (m)
    phi = np.deg2rad(latitude)
    f0 = 2.0 * omega * np.sin(phi)
    beta = 2.0 * omega * np.cos(phi) / r_earth
    return f0, beta
