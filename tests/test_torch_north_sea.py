"""The I/O and forcing slice as a whole: ``demos/demo_2d_north_sea.py``
through ``thetis_tpu_torch`` against ``thetis_tpu`` (f64, CPU).

The demo's case at its own size (40 km, 665 cells): the unstructured
coastline mesh of ``demos/north_sea_mesh.py`` (open boundary tag 100,
coasts 200), Coriolis from latitude through UTM zone 30, Manning drag,
DIRK22 semi-implicit, the synthetic TPXO-format netCDF3 file written under
``tmp_path`` and read back through ``TPXOTidalBoundaryForcing``, the
boundary elevation set every step through ``iterate(update_forcings=...)``
and the three tide-gauge stations evaluated every step, with exports on
(VTK, HDF5 checkpoints, the stations' HDF5 series).  Two steps
(``THETIS_REGRESSION_TEST``'s length).  The port's case is
``chip_smoke.north_sea_solver``, whose copy of the mesh generator must
give the demo generator's arrays.

Tolerances: elevation, velocity, the station series and the checkpoint
datasets 1e-9 of each one's largest magnitude (the DIRK22 stages' FGMRES
stops at its tolerance in two summation orders); the mesh, the export
file names, times and iterations exactly; ``tests/test_north_sea.py``'s
bounds for the port."""
import datetime
import glob
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "demos"))

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from north_sea_mesh import make_north_sea_mesh  # noqa: E402

RTOL = 1e-9
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_case(outdir):
    """The demo's lines (demo_2d_north_sea.py:28-161) through
    ``thetis_tpu``, exports on, the TPXO file in ``outdir``."""
    from thetis_tpu import Constant, Function, FunctionSpace, solver2d
    from thetis_tpu import TimeSeriesCallback2D, pi, sin
    from thetis_tpu.model.forcing import TPXOTidalBoundaryForcing
    from thetis_tpu.utils.timezone import FixedTimeZone

    mesh2d, cs = make_north_sea_mesh(resolution_km=chip_smoke.NS_RES_KM)
    P1 = FunctionSpace(mesh2d, "CG", 1)
    lon, lat = cs.get_mesh_lonlat_function(mesh2d)
    bathy = Function(P1, name="Bathymetry")
    bathy.data = jnp.asarray(np.clip(
        20.0 + 150.0 * np.clip((np.asarray(lat) - 50.0) / 12.0, 0, 1) ** 2
        + 30.0 * np.cos(np.deg2rad(np.asarray(lon)) * 3), 10.0, 700.0))
    manning = Function(P1, name="Manning coefficient").assign(
        chip_smoke.NS_MANNING)
    coriolis = Function(P1, name="Coriolis forcing").interpolate(
        2 * chip_smoke.NS_OMEGA * sin(np.asarray(lat) * pi / 180.0))
    dt = chip_smoke.NS_DT
    s = solver2d.FlowSolver2d(mesh2d, bathy)
    o = s.options
    o.element_family = "dg-dg"
    o.polynomial_degree = 1
    o.coriolis_frequency = coriolis
    o.manning_drag_coefficient = manning
    o.horizontal_velocity_scale = Constant(1.5)
    o.use_lax_friedrichs_velocity = True
    o.simulation_export_time = dt
    o.simulation_end_time = STEPS * dt
    o.swe_timestepper_type = "DIRK22"
    o.swe_timestepper_options.use_semi_implicit_linearization = True
    o.timestep = dt
    o.fields_to_export = ["elev_2d", "uv_2d"]
    o.no_exports = False
    o.output_directory = os.path.join(outdir, "outputs")
    init_date = datetime.datetime(*chip_smoke.NS_INIT_DATE,
                                  tzinfo=FixedTimeZone(0, "UTC"))
    open_nodes = np.unique(
        mesh2d.facet_verts_np[mesh2d.facet_marker_np == 100].ravel())
    chip_smoke.write_north_sea_tpxo(
        os.path.join(outdir, chip_smoke.NS_TPXO_NAME))
    tide = TPXOTidalBoundaryForcing(
        np.stack([np.asarray(lat)[open_nodes],
                  np.asarray(lon)[open_nodes]], axis=-1), init_date,
        constituents=["M2", "S2"], data_dir=outdir,
        elev_file=chip_smoke.NS_TPXO_NAME)
    elev_bc = Function(P1, name="tidal elevation")
    s.bnd_functions["shallow_water"] = {100: {"elev": elev_bc}, 200: {}}

    def update_forcings(t):
        vals = np.zeros(mesh2d.nv)
        vals[open_nodes] = tide.set_tidal_field(t)
        elev_bc.data = jnp.asarray(vals)

    update_forcings(0.0)
    s.assign_initial_conditions(elev=elev_bc)
    stations = {}
    for name, (slat, slon) in chip_smoke.NS_STATIONS.items():
        x, y = cs.to_xy(slon, slat)
        stations[name] = TimeSeriesCallback2D(
            s, ["elev_2d"], float(x), float(y), name, append_to_log=False,
            export_to_hdf5=True)
        s.add_callback(stations[name], "timestep")
    return s, update_forcings, stations


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs, once per module (the reference's DIRK22
    compile is the costly part)."""
    out = {}
    jdir = str(tmp_path_factory.mktemp("ref"))
    js, juf, jst = reference_case(jdir)
    js.iterate(update_forcings=juf)
    out["ref"] = (js, jst, jdir)
    tdir = str(tmp_path_factory.mktemp("port"))
    ts, tuf, tst = chip_smoke.north_sea_solver(
        torch.device("cpu"), torch.float64, tdir, steps=STEPS,
        station_hdf5=True)
    ts.iterate(update_forcings=tuf)
    out["port"] = (ts, tst, tdir)
    return out


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def test_mesh_generator_copy_gives_the_demo_arrays():
    ref, _ = make_north_sea_mesh(resolution_km=chip_smoke.NS_RES_KM)
    coords, cells, markers, _ = chip_smoke.north_sea_mesh_arrays(
        chip_smoke.NS_RES_KM)
    tm = chip_smoke.Mesh2d(coords, cells, boundary_markers=markers,
                           device="cpu", dtype=torch.float64)
    assert (ref.nc, ref.nv) == (665, 369)
    assert np.array_equal(coords, ref.coords_np)
    assert np.array_equal(tm.cells_np, ref.cells_np)
    assert np.array_equal(tm.facet_marker_np, ref.facet_marker_np)
    assert set(np.unique(ref.facet_marker_np)) >= {100, 200}


@pytest.mark.parametrize("key", ["elev_2d", "uv_2d"])
def test_fields_agree(runs, key):
    js, ts = runs["ref"][0], runs["port"][0]
    assert ts.iteration == js.iteration == STEPS
    assert ts.simulation_time == js.simulation_time
    got = ts.fields[key].data.numpy()
    assert rel(got, np.asarray(js.fields[key].data)) <= RTOL


def test_station_series_agree(runs):
    (js, jst, jdir), (ts, tst, tdir) = runs["ref"], runs["port"]
    assert len(ts.callbacks["timestep"]) == 3
    for name in chip_smoke.NS_STATIONS:
        assert rel(tst[name]()[0], jst[name]()[0]) <= RTOL
        fn = f"diagnostic_timeseries_{name}.hdf5"
        with h5py.File(os.path.join(jdir, "outputs", fn)) as jf, \
                h5py.File(os.path.join(tdir, "outputs", fn)) as tf:
            assert sorted(jf) == sorted(tf) == sorted(["time", name])
            assert np.array_equal(tf["time"][:], jf["time"][:])
            assert tf[name].shape == jf[name].shape == (STEPS, 1)
            assert rel(tf[name][:], jf[name][:]) <= RTOL


def test_checkpoint_files_agree(runs):
    jdir, tdir = runs["ref"][2], runs["port"][2]
    jfiles = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(jdir, "outputs", "hdf5", "*.h5")))
    tfiles = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(tdir, "outputs", "hdf5", "*.h5")))
    assert tfiles == jfiles
    assert len(tfiles) == 2 * (STEPS + 1) + 1  # elev and uv, and mesh.h5
    for fn in tfiles:
        with h5py.File(os.path.join(jdir, "outputs", "hdf5", fn)) as jf, \
                h5py.File(os.path.join(tdir, "outputs", "hdf5", fn)) as tf:
            assert sorted(tf) == sorted(jf)
            assert sorted(tf.attrs) == sorted(jf.attrs)
            assert all(tf.attrs[k] == jf.attrs[k] for k in jf.attrs)
            for k in jf:
                if fn == "mesh.h5":
                    assert np.array_equal(tf[k][:], jf[k][:])
                else:
                    assert rel(tf[k][:], jf[k][:]) <= RTOL


def test_export_series_files_agree(runs):
    """The same VTK series in both (file names and the .pvd's times)."""
    jdir, tdir = runs["ref"][2], runs["port"][2]
    for sub in ("Elevation2d", "Velocity2d"):
        jf = sorted(os.listdir(os.path.join(jdir, "outputs", sub)))
        tf = sorted(os.listdir(os.path.join(tdir, "outputs", sub)))
        assert tf == jf and len(tf) == STEPS + 2
        pvd = f"{sub}.pvd"
        with open(os.path.join(jdir, "outputs", sub, pvd)) as a, \
                open(os.path.join(tdir, "outputs", sub, pvd)) as b:
            assert b.read() == a.read()


def test_demo_bounds_hold_for_the_port(runs):
    """``tests/test_north_sea.py``'s checks, on the port's run."""
    ts = runs["port"][0]
    e = ts.fields.elev_2d.data.numpy()
    u = ts.fields.uv_2d.data.numpy()
    assert np.isfinite(e).all() and np.isfinite(u).all()
    assert 1e-3 < np.abs(u).max() < 10.0
    assert np.abs(e).max() < 10.0
    assert len(ts.callbacks["timestep"]) == 3
