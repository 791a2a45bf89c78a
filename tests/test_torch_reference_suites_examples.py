"""The reference's file-driven Columbia plume case
(``tests/test_examples.py::test_columbia_plume_file_driven_forcing``)
through ``thetis_tpu_torch`` on the CPU in f64: NCOM-format initial
temperature and salinity and ERA5-format wind written as the reference
test writes them, and ``examples/columbia_plume/cre_plume.py`` run from
its source at regression size (``chip_smoke.run_script``), its file
branches taken and the NCOM salinity in its initial state."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
netcdf = pytest.importorskip("scipy.io")

import chip_smoke  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401


def write_archives(base):
    """The reference test's NCOM archive (8 x 8 x 4 over the UTM-10 shelf,
    days 1-3 of May 2006, S 33.5, T 12) and ERA5-format wind (8 m/s
    eastward, two times a week apart)."""
    nlat, nlon, nz = 8, 8, 4
    lon, lat = np.meshgrid(np.linspace(-127.0, -121.0, nlon),
                           np.linspace(44.0, 48.0, nlat))
    ncom = base / "ncom"
    ncom.mkdir()
    with netcdf.netcdf_file(str(ncom / "model_lat.nc"), "w") as f:
        f.createDimension("Y", nlat)
        f.createDimension("X", nlon)
        f.createVariable("Lat", "d", ("Y", "X"))[:] = lat
    with netcdf.netcdf_file(str(ncom / "model_lon.nc"), "w") as f:
        f.createDimension("Y", nlat)
        f.createDimension("X", nlon)
        f.createVariable("Long", "d", ("Y", "X"))[:] = lon
    z_levels = np.array([-1.0, -50.0, -200.0, -2000.0])
    with netcdf.netcdf_file(str(ncom / "model_zm.nc"), "w") as f:
        f.createDimension("Z", nz)
        f.createDimension("Y", nlat)
        f.createDimension("X", nlon)
        f.createVariable("zm", "d", ("Z", "Y", "X"))[:] = np.broadcast_to(
            z_levels[:, None, None], (nz, nlat, nlon)).copy()
    for day in (1, 2, 3):
        for fieldstr, var, val in (("s3d", "Salinity", 33.5),
                                   ("t3d", "Temperature", 12.0)):
            d = ncom / "2006" / fieldstr
            d.mkdir(parents=True, exist_ok=True)
            fn = d / f"{fieldstr}.glb8_2f_200605{day:02d}00.nc"
            with netcdf.netcdf_file(str(fn), "w") as f:
                f.createDimension("X", nlon)
                f.createDimension("Y", nlat)
                f.createDimension("Z", nz)
                f.createVariable("X_Index", "d", ("X",))[:] = np.arange(nlon)
                f.createVariable("Y_Index", "d", ("Y",))[:] = np.arange(nlat)
                f.createVariable(var, "d", ("Z", "Y", "X"))[:] = np.full(
                    (nz, nlat, nlon), val)
    atm = base / "atm"
    atm.mkdir()
    with netcdf.netcdf_file(str(atm / "wind_000.nc"), "w") as f:
        f.createDimension("valid_time", 2)
        f.createDimension("longitude", 5)
        f.createDimension("latitude", 5)
        tv = f.createVariable("valid_time", "d", ("valid_time",))
        tv[:] = [0.0, 7 * 86400.0]
        tv._attributes["units"] = b"seconds since 2006-05-01 00:00:00"
        f.createVariable("longitude", "d", ("longitude",))[:] = np.linspace(
            -127.0, -121.0, 5)
        f.createVariable("latitude", "d", ("latitude",))[:] = np.linspace(
            48.0, 44.0, 5)
        for name, val in (("u10", 8.0), ("v10", 0.0), ("msl", 101325.0)):
            f.createVariable(name, "d", ("valid_time", "latitude",
                                         "longitude"))[:] = np.full(
                                             (2, 5, 5), val)


def test_columbia_plume_file_driven_forcing(tmp_path, monkeypatch):
    write_archives(tmp_path)
    monkeypatch.setenv("CRE_FORCING_DIR", str(tmp_path))
    monkeypatch.setenv("CRE_INIT_DATE", "2006-05-01")
    ns = chip_smoke.run_script("examples/columbia_plume/cre_plume.py",
                               "cpu", torch.float64).namespace
    assert ns["USE_NCOM"] and ns["USE_ATM"], "file branches not taken"
    salt0 = ns["salt0"]
    salt0 = (salt0.cpu().numpy() if isinstance(salt0, torch.Tensor)
             else np.asarray(salt0))
    assert abs(float(salt0.max()) - 33.5) < 0.6
