"""The repo's 3D examples (``examples/*/`` on ``FlowSolver``) through the
port, from their own source, on the CPU in f64 (``chip_smoke.run_script``:
the script rewritten by ``chip_smoke.REWRITE_TABLE``, nothing else): each
passes its own checks; ``channel3d_waveEq`` also matches ``thetis_tpu``
(CPU, x64) field by field in tier-1 (the cheapest reference 3D compile;
``test_torch_demos.py`` holds ``demo_3d_channel`` there), the others in
``slow``.  The lock
exchange fails at regression size in the reference: in its 50 steps the
cold bottom front does not leave the midline (``front_x`` = lx/2 = 32
km), so its last assert fails; the port fails it the same way, and in
``slow`` at the same front and fields.

The reference's file-driven Columbia plume case
(``tests/test_examples.py::test_columbia_plume_file_driven_forcing``)
closes the file: NCOM-format initial temperature and salinity and
ERA5-format wind written as the reference test writes them, and
``examples/columbia_plume/cre_plume.py`` run from its source at
regression size, its file branches taken and the NCOM salinity in its
initial state.

Tolerance: rtol 1e-9 of each field's scale (``test_torch_demos.py``);
two longer GLS runs 1e-6 and ROFI 1e-4 (:data:`PARITY_RTOL`, with the
reasons)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from test_torch_demos import (  # noqa: E402,F401
    RTOL, assert_fields_match, assert_finite, keep_constants,
    one_torch_thread, run_port, run_reference, script_params)

SLOW = (pytest.mark.slow,)
#: the 3D examples; ``slow`` where the port's run takes over ~20 s on one
#: CPU thread (the file's tier-1 share stays near 100 s with a cold
#: ``.jax_cache/``: a reference 3D compile takes ~40-110 s)
SCRIPTS = {
    "examples/baroclinic_channel/baroclinic_channel.py": (),
    "examples/baroclinic_eddies/baroclinic_eddies.py": (),
    "examples/bottomFriction/ekman_bottom.py": (),
    "examples/bottomFriction/ekman_surface.py": (),
    "examples/bottomFriction/steadyChannel.py": (),
    "examples/channel3d/channel3d.py": SLOW,
    "examples/columbia_plume/cre_plume.py": (),
    "examples/dome/dome.py": SLOW,
    "examples/freshwaterCylinder/freshwaterCylinder.py": (),
    "examples/idealizedEstuary/warnerEstuary.py": (),
    "examples/katophillips/katophillips.py": (),
    "examples/lockExchange/lockExchange.py": (),
    "examples/overflow/overflow.py": (),
    "examples/rhineROFI/rhineROFI.py": (),
    "examples/stommel3d/stommel3d.py": SLOW,
    "examples/tracerBox/tracerBox3d.py": (),
    "examples/waveEq3d/channel3d_waveEq.py": (),
}
#: held to the reference in tier-1; the others in ``slow``
PARITY = ("examples/waveEq3d/channel3d_waveEq.py",)
#: scripts the reference fails at regression size (ROADMAP C)
REFERENCE_FAILS = (chip_smoke.LOCK_EXCHANGE,)
#: held to other tolerances than ``test_torch_demos.RTOL``.  The GLS
#: closure amplifies summation-order roundoff step by step (its powers,
#: floors and limiter; ``test_torch_3d_gls.py`` holds three steps to
#: 1e-8): measured 3.0e-8 of uv_3d in the Columbia plume (8 steps) and
#: 8.4e-8 of nu_v in the estuary (54 steps).  ROFI starts with salinity
#: uniform in the vertical, where the sign of the buoyancy flux is
#: roundoff and picks the closure's c3 (ROADMAP C: a 1e-15 change moves
#: nu_v by ~4e-5 of its scale): measured 2.7e-5 of mu_v in 10 steps.
GLS_RTOL = 1e-6
ROFI_RTOL = 1e-4
PARITY_RTOL = {"examples/columbia_plume/cre_plume.py": GLS_RTOL,
               "examples/idealizedEstuary/warnerEstuary.py": GLS_RTOL,
               "examples/rhineROFI/rhineROFI.py": ROFI_RTOL}


@pytest.mark.parametrize("script", script_params(SCRIPTS))
def test_example_runs_through_the_port(script):
    ns, solvers = {}, []
    if script in REFERENCE_FAILS:
        with pytest.raises(Exception) as e:
            run_port(script, ns, solvers)
        assert chip_smoke.fails_as_the_reference(script, e.value, ns)
    else:
        run_port(script, ns, solvers)
    assert solvers
    assert_finite(solvers)


@pytest.mark.parametrize("script", script_params(
    {p: m for p, m in SCRIPTS.items() if p not in REFERENCE_FAILS}, PARITY))
def test_example_matches_the_reference(script, tmp_path):
    ref = run_reference(script, tmp_path).solvers
    assert_fields_match(run_port(script).solvers, ref,
                        PARITY_RTOL.get(script, RTOL))


@pytest.mark.slow
@pytest.mark.parametrize("script", REFERENCE_FAILS)
def test_example_fails_as_the_reference(script, tmp_path):
    """Both packages stop at the same assert with the front at the same
    place and the same fields."""
    ref_ns, port_ns, ref, port = {}, {}, [], []
    with pytest.raises(AssertionError):
        run_reference(script, tmp_path, ref_ns, ref)
    with pytest.raises(AssertionError):
        run_port(script, port_ns, port)
    assert port_ns["front_x"] == ref_ns["front_x"] == ref_ns["lx"] / 2
    assert_fields_match(port, ref)


# -- tests/test_examples.py::test_columbia_plume_file_driven_forcing ----
def write_archives(base):
    """The reference test's NCOM archive (8 x 8 x 4 over the UTM-10 shelf,
    days 1-3 of May 2006, S 33.5, T 12) and ERA5-format wind (8 m/s
    eastward, two times a week apart)."""
    netcdf = pytest.importorskip("scipy.io")
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
