"""File-driven forcing and the netCDF layer, ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): every case of ``tests/test_forcing_files.py``
and ``tests/test_netcdf_io.py`` through both packages, on the same
synthetic files (written under ``tmp_path`` by those tests' own writers):
tidal astronomy, TPXO and FES2004 boundary forcing, the atmospheric,
generic 2D and ocean 3D interpolators, the ERA5, TCHazards, NCOM and
LiveOcean adapters, CF time units, NetCDF-3 and NetCDF-4 files, time
search and time-series interpolation.  One more case sets ERA5 wind
stress and pressure into the port's fields, which keep their device and
dtype.

Tolerance: 1e-12 relative (the port's copies of the same numpy and
scipy code); names, shapes and file choices exactly."""
import datetime

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from test_forcing_files import (  # noqa: E402
    _write_era5_file, _write_ncom_fixture, write_atm_file, write_fes_file,
    write_tpxo_file)
from test_netcdf_io import write_nc3, write_nc4  # noqa: E402

import thetis_tpu.model.forcing as jforcing  # noqa: E402
import thetis_tpu.model.forcing_adapters as jadapt  # noqa: E402
import thetis_tpu.utils.netcdf_io as jnc  # noqa: E402
import thetis_tpu.utils.tides as jtides  # noqa: E402
import thetis_tpu.utils.timezone as jtz  # noqa: E402
import thetis_tpu_torch.model.forcing as tforcing  # noqa: E402
import thetis_tpu_torch.model.forcing_adapters as tadapt  # noqa: E402
import thetis_tpu_torch.utils.netcdf_io as tnc  # noqa: E402
import thetis_tpu_torch.utils.tides as ttides  # noqa: E402
import thetis_tpu_torch.utils.timezone as ttz  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12
PKGS = {"ref": dict(forcing=jforcing, adapt=jadapt, nc=jnc, tides=jtides,
                    tz=jtz),
        "port": dict(forcing=tforcing, adapt=tadapt, nc=tnc, tides=ttides,
                     tz=ttz)}


def init(pkg):
    return datetime.datetime(2024, 3, 1,
                             tzinfo=pkg["tz"].FixedTimeZone(0, "UTC"))


def agree(a, b, path="out"):
    """Nested dicts/lists/tuples of arrays, numbers and strings: the same
    structure, numbers within RTOL of each array's scale."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            agree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)) and not np.isscalar(b):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            agree(x, y, f"{path}[{i}]")
    elif isinstance(b, str):
        assert a == b, path
    else:
        x, y = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
        assert x.shape == y.shape, path
        scale = max(float(np.abs(y).max(initial=0.0)), 1e-300)
        assert float(np.abs(x - y).max(initial=0.0)) <= RTOL * scale, path


def both(case, *args):
    """``case(pkg, *args)`` for each package; their results agree."""
    out = {name: case(pkg, *args) for name, pkg in PKGS.items()}
    agree(out["port"], out["ref"])
    return out["port"]


# -- tides.py ----------------------------------------------------------
def test_constituent_tables_and_nodal_corrections():
    def case(p):
        t = p["tides"]
        corr = [t.nodal_corrections(c, N) for N in np.linspace(0, 360, 13)
                for c in ("M2", "S2", "K1", "O1", "K2", "P1", "N2")]
        return dict(speeds=dict(t.CONSTITUENT_SPEEDS), corr=corr,
                    freq=dict(p["forcing"].CONSTITUENT_FREQUENCIES))

    out = both(case)
    assert out["speeds"]["M2"] == pytest.approx(28.9841042)


def test_tides_prediction():
    A, g = 1.5, 0.7

    def case(p):
        tide = p["tides"].Tides(["M2", "S2", "K1"])
        tide.set_initial_time(init(p))
        ts = np.linspace(0.0, 90000.0, 37)
        return dict(
            amp=[tide.from_amplitude_phase([A, 0.4, 0.2], [g, 0.1, 1.3], t)
                 for t in ts],
            cplx=[tide.from_complex([A * np.cos(g), 0.3, 0.1],
                                    [-A * np.sin(g), 0.2, -0.1], t)
                  for t in ts], f=tide.f)

    both(case)


# -- forcing.py --------------------------------------------------------
def test_wind_stress_formulae():
    rng = np.random.default_rng(0)
    u, v = 20 * rng.standard_normal((2, 50))
    both(lambda p: [p["forcing"].compute_wind_stress(u, v, m)
                    for m in ("LargeYeager2009", "LargePond1981")]
         + [p["forcing"].smooth_wind_stress(u, v, 0.3)])


def test_harmonic_tidal_boundary_forcing():
    rng = np.random.default_rng(1)
    amp = {"M2": rng.uniform(0, 2, 6), "K1": rng.uniform(0, 1, 6)}
    pha = {"M2": rng.uniform(0, 6, 6), "K1": rng.uniform(0, 6, 6)}
    both(lambda p: [p["forcing"].TidalBoundaryForcing(
        amp, pha, nodal_factors={"M2": 0.97}, initial_time=50.0
    ).set_tidal_field(t) for t in (0.0, 3600.0, 7e4)])


def test_tpxo_tidal_boundary_forcing(tmp_path):
    lon_ax = np.linspace(0.0, 10.0, 11)
    lat_ax = np.linspace(50.0, 60.0, 11)
    LON, LAT = np.meshgrid(lon_ax, lat_ax, indexing="ij")
    h_re = np.stack([0.1 * LON + 0.01 * LAT, np.full_like(LON, 0.3)])
    h_im = np.stack([0.02 * LAT, np.full_like(LON, 0.1)])
    write_tpxo_file(tmp_path / "h_test.nc", lon_ax, lat_ax, ["m2", "s2"],
                    h_re, h_im)
    latlon = np.array([[55.0, 2.0], [55.0, 8.0], [51.3, 0.7]])

    def case(p, constituents):
        tb = p["forcing"].TPXOTidalBoundaryForcing(
            latlon, init(p), constituents=constituents,
            data_dir=str(tmp_path), elev_file="h_test.nc")
        return dict(names=list(tb.constituents), h_re=tb.h_re, h_im=tb.h_im,
                    eta=[tb.set_tidal_field(t) for t in (0.0, 3600.0, 7200.0)])

    assert both(case, None)["names"] == ["M2", "S2"]
    assert both(case, ["M2"])["names"] == ["M2"]


def test_atm_netcdf_interpolator(tmp_path):
    lon_ax = np.linspace(0.0, 4.0, 5)
    lat_ax = np.linspace(50.0, 54.0, 5)
    rng = np.random.default_rng(2)
    u, v = 10 + 5 * rng.standard_normal((2, 2, 5, 5))
    p_ = 101325.0 + 100 * rng.standard_normal((2, 5, 5))
    write_atm_file(tmp_path / "wind_000.nc", [0.0, 3600.0], lon_ax, lat_ax,
                   u, v, p_)
    target = np.array([[1.0, 51.0], [3.0, 53.0], [2.2, 50.4]])
    both(lambda p: [p["forcing"].ATMNetCDFInterpolator(
        target, str(tmp_path / "wind_*.nc"), init(p)).set_fields(t)
        for t in (0.0, 1800.0, 3000.0)])


def test_fes2004_tidal_boundary_forcing(tmp_path):
    lat_ax = np.linspace(50.0, 60.0, 11)
    lon_ax = np.linspace(0.0, 10.0, 11)
    LAT, LON = np.meshgrid(lat_ax, lon_ax, indexing="ij")
    amp = np.stack([100.0 + 10.0 * LAT / 60.0, 20.0 + LON])
    pha = np.stack([30.0 + 0.0 * LAT, 5.0 * LON])
    write_fes_file(tmp_path / "tide.fes2004.nc", lat_ax, lon_ax,
                   ["m2", "k1"], amp, pha)
    latlon = np.array([[55.0, 5.0], [52.5, 1.5]])

    def case(p):
        tb = p["forcing"].FES2004TidalBoundaryForcing(
            latlon, init(p), data_dir=str(tmp_path))
        return dict(names=list(tb.constituents), amp=tb.amplitudes,
                    pha=tb.phases,
                    eta=[tb.set_tidal_field(t) for t in (0.0, 4000.0)])

    both(case)


def test_generic_2d_and_ocean_3d_interpolators(tmp_path):
    from scipy.io import netcdf_file

    lon_ax = np.linspace(0.0, 4.0, 5)
    lat_ax = np.linspace(50.0, 54.0, 5)
    z_ax = np.array([0.0, 10.0, 50.0])
    rng = np.random.default_rng(3)
    with netcdf_file(str(tmp_path / "ocean_000.nc"), "w") as f:
        f.createDimension("time", 2)
        f.createDimension("lon", 5)
        f.createDimension("lat", 5)
        f.createDimension("depth", 3)
        tv = f.createVariable("time", "d", ("time",))
        tv[:] = [0.0, 3600.0]
        tv._attributes["units"] = b"seconds since 2024-03-01"
        f.createVariable("lon", "d", ("lon",))[:] = lon_ax
        f.createVariable("lat", "d", ("lat",))[:] = lat_ax
        f.createVariable("depth", "d", ("depth",))[:] = z_ax
        f.createVariable("salinity", "d", ("time", "depth", "lat", "lon"))[
            :] = 30.0 + rng.standard_normal((2, 3, 5, 5))
        f.createVariable("sst", "d", ("time", "lat", "lon"))[
            :] = 15.0 + rng.standard_normal((2, 5, 5))
    target = np.array([[1.0, 51.0], [3.0, 53.0], [0.5, 53.7]])
    pattern = str(tmp_path / "ocean_*.nc")

    def case(p):
        g2 = p["forcing"].GenericNetCDFInterpolator2D(target, pattern,
                                                      init(p), ["sst"])
        o3 = p["forcing"].Ocean3DInterpolator(target, pattern, init(p),
                                              ["salinity"])
        return dict(g2=[g2.set_fields(t) for t in (0.0, 1800.0)],
                    o3=[o3.set_fields(t, np.array([-5.0, -30.0, -1.0]))
                        for t in (0.0, 2700.0)])

    both(case)


# -- forcing_adapters.py ---------------------------------------------
def era5_files(tmp_path):
    lon_ax = np.linspace(0.0, 4.0, 5)
    lat_ax = np.linspace(54.0, 50.0, 5)  # descending, as ERA5 ships
    rng = np.random.default_rng(4)
    u, v = 8 + 3 * rng.standard_normal((2, 2, 5, 5))
    p = 101000.0 + 50 * rng.standard_normal((2, 5, 5))
    _write_era5_file(tmp_path / "era5_000.nc", [0.0, 3600.0], lon_ax,
                     lat_ax, u, v, p)
    return str(tmp_path / "era5_*.nc")


def test_era5_interpolator(tmp_path):
    pattern = era5_files(tmp_path)
    target = np.array([[1.0, 51.0], [3.0, 53.0], [2.5, 52.2]])

    def case(p, units):
        era = p["adapt"].ERA5Interpolator(
            target, pattern, init(p), lon_name="longitude",
            lat_name="latitude", pressure_units=units)
        return [era.set_fields(t) for t in (0.0, 1800.0, 3600.0)]

    both(case, "pa")
    both(case, "hpa")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_era5_sets_the_port_s_fields_on_their_device(tmp_path, dtype):
    """ERA5 wind stress and pressure set into the port's CG1 fields: the
    host's numpy values, on the field's device, in its dtype."""
    from thetis_tpu_torch.fem.functionspace import Function, FunctionSpace
    from thetis_tpu_torch.mesh.generation import RectangleMesh

    pattern = era5_files(tmp_path)
    mesh = RectangleMesh(3, 2, 1.0, 1.0, device="cpu", dtype=dtype)
    P1 = FunctionSpace(mesh, "CG", 1)
    n = mesh.nv
    tgt = np.column_stack([np.linspace(1, 3, n), np.linspace(51, 53, n)])
    wind = Function(FunctionSpace(mesh, "CG", 1, dim=2), name="wind")
    pres = Function(P1, name="pres")
    era = tadapt.ERA5Interpolator(
        tgt, pattern, init(PKGS["port"]), lon_name="longitude",
        lat_name="latitude", wind_stress_field=wind,
        atm_pressure_field=pres)
    out = era.set_fields(900.0)
    ref = jadapt.ERA5Interpolator(
        tgt, pattern, init(PKGS["ref"]), lon_name="longitude",
        lat_name="latitude").set_fields(900.0)
    agree(out, ref)
    for f, key in ((wind, "wind_stress"), (pres, "atmospheric_pressure")):
        assert f.data.dtype == dtype and f.data.device == mesh.device
        assert np.array_equal(f.data.numpy(),
                              out[key].astype(f.data.numpy().dtype))


def test_tchazards_interpolator(tmp_path):
    from scipy.io import netcdf_file

    with netcdf_file(str(tmp_path / "tc_000.nc"), "w") as f:
        f.createDimension("time", 2)
        f.createDimension("lon", 5)
        f.createDimension("lat", 5)
        tv = f.createVariable("time", "d", ("time",))
        tv[:] = [0.0, 3600.0]
        tv._attributes["units"] = b"seconds since 2024-03-01 00:00:00"
        f.createVariable("lon", "d", ("lon",))[:] = np.linspace(0, 4, 5)
        f.createVariable("lat", "d", ("lat",))[:] = np.linspace(50, 54, 5)
        rng = np.random.default_rng(5)
        for name, val in (("Uw", 8.0), ("Vw", 1.0), ("Pr", 1010.0)):
            f.createVariable(name, "d", ("time", "lat", "lon"))[
                :] = val + rng.standard_normal((2, 5, 5))
    target = np.array([[2.0, 52.0], [1.1, 50.9]])
    both(lambda p: p["adapt"].TCHazardsInterpolator(
        target, str(tmp_path / "tc_*.nc"), init(p)).set_fields(600.0))


def test_ncom_interpolator(tmp_path):
    base = _write_ncom_fixture(tmp_path)
    tgt3 = np.array([[52.0, 2.0, -10.0], [53.0, 3.0, -60.0]])
    tgt2 = np.array([[52.0, 2.0], [53.0, 3.0]])

    def case(p):
        ncom = p["adapt"].NCOMInterpolator(
            tgt3, tgt2, fields={"Salinity": None, "Temperature": None,
                                "Surface_Elevation": None},
            field_fnstr={"Salinity": "s3d", "Temperature": "t3d",
                         "Surface_Elevation": "ssh"},
            basedir=str(base),
            file_pattern="{year:04d}/{fieldstr:}/{fieldstr:}.glb8_2f_"
                         "{year:04d}{month:02d}{day:02d}00.nc",
            init_date=init(p))
        return [ncom.set_fields(t) for t in (0.0, 12 * 3600.0)]

    both(case)


def test_liveocean_interpolator(tmp_path):
    from scipy.io import netcdf_file

    neta, nxi, nz = 8, 10, 5
    LON, LAT = np.meshgrid(np.linspace(-2.0, 7.0, nxi),
                           np.linspace(49.0, 56.0, neta))
    mask = np.ones((neta, nxi))
    mask[0, 0] = 0.0
    s_w = np.linspace(-1.0, 0.0, nz + 1)
    rng = np.random.default_rng(6)
    for i, tval in enumerate((0.0, 43200.0)):
        with netcdf_file(str(tmp_path / f"ocean_{i:03d}.nc"), "w") as f:
            for dim, n in (("ocean_time", 1), ("eta_rho", neta),
                           ("xi_rho", nxi), ("s_rho", nz),
                           ("s_wdim", nz + 1), ("one", 1)):
                f.createDimension(dim, n)
            tv = f.createVariable("ocean_time", "d", ("ocean_time",))
            tv[:] = [tval]
            tv._attributes["units"] = b"seconds since 2024-03-01 00:00:00"
            rho = ("eta_rho", "xi_rho")
            f.createVariable("lat_rho", "d", rho)[:] = LAT
            f.createVariable("lon_rho", "d", rho)[:] = LON
            f.createVariable("mask_rho", "d", rho)[:] = mask
            f.createVariable("h", "d", rho)[:] = 150.0 + 50 * rng.uniform(
                size=(neta, nxi))
            f.createVariable("Cs_w", "d", ("s_wdim",))[:] = s_w
            f.createVariable("s_w", "d", ("s_wdim",))[:] = s_w
            f.createVariable("hc", "d", ("one",))[:] = [10.0]
            f.createVariable("salt", "d", ("ocean_time", "s_rho") + rho)[
                :] = 30.0 + rng.standard_normal((1, nz, neta, nxi))
    tgt3 = np.array([[52.0, 2.0, -10.0], [53.0, 3.0, -100.0]])
    both(lambda p: [p["adapt"].LiveOceanInterpolator(
        tgt3, {"salt": None}, str(tmp_path / "ocean_*.nc"),
        init(p)).set_fields(t) for t in (0.0, 21600.0)])


# -- netcdf_io.py ------------------------------------------------------
def test_parse_time_units():
    both(lambda p: [p["nc"].parse_time_units(u) for u in (
        "seconds since 1970-01-01 00:00:00", "hours since 2000-01-01",
        "days since 2000-01-01 00:00:00-05:00",
        "minutes since 2010-06-15T12:30:00Z")])


@pytest.mark.parametrize("writer", [write_nc3, write_nc4])
def test_ncfile_and_varname(tmp_path, writer):
    writer(tmp_path / "f.nc", [0.0, 1.0], "hours since 2020-01-01", {
        "elev": ([1.0, 2.0], {"standard_name": "sea_surface_elevation"}),
        "speed": ([3.0, 4.0], {"long_name": "Flow Speed"})})

    def case(p):
        with p["nc"].NCFile(str(tmp_path / "f.nc")) as d:
            names = [p["nc"].get_ncvar_name(d, **kw) for kw in (
                dict(standard_name="sea_surface_elevation"),
                dict(long_name="flow speed", standard_name="nope"),
                dict(var_name="elev", standard_name="nope"))]
            return dict(names=names, elev=d.variables["elev"][:],
                        time=d.variables["time"][:])

    assert both(case)["names"] == ["elev", "speed", "elev"]


def test_time_parser_search_and_interpolator(tmp_path):
    units = "seconds since 2020-01-01 00:00:00"
    write_nc3(tmp_path / "a_000.nc", [0.0, 600.0, 1200.0], units,
              {"v": ([0.0, 1.0, 2.0], {})})
    write_nc3(tmp_path / "a_001.nc", [1800.0, 2400.0], units,
              {"v": ([3.0, 4.0], {})})

    def case(p):
        d0 = datetime.datetime(2020, 1, 1,
                               tzinfo=p["tz"].FixedTimeZone(0, "UTC"))
        base = p["tz"].datetime_to_epoch(d0)
        tp = p["nc"].NetCDFTimeParser(str(tmp_path / "a_000.nc"))
        ts = p["nc"].NetCDFTimeSearch(str(tmp_path / "a_*.nc"), init_date=d0)
        found = [ts.find(t, previous=prev) for t in (1200.0, 1300.0, 2000.0)
                 for prev in (True, False)]
        itp = p["nc"].NetCDFTimeSeriesInterpolator(
            str(tmp_path / "a_*.nc"), ["v"], d0, scalars=[2.0])
        return dict(times=tp.time_array - base, step=tp.time_step,
                    stamps=[tp.find_time_stamp(base + 600.0),
                            tp.find_time_stamp(base + 650.0, previous=True)],
                    found=[(f[0][-8:], f[1], f[2]) for f in found],
                    values=[itp(t) for t in (50.0, 700.0, 1500.0, 2100.0)])

    both(case)
