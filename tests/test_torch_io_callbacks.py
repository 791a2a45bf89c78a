"""The detector, station, profile, transect and accumulator callbacks and
the diagnostic HDF5 series, ``thetis_tpu_torch`` against ``thetis_tpu``
(f64, CPU).

* ``tests/test_3d.py``'s station case (a linear-in-z temperature on 6x4
  x 5 layers): both packages recover 15 + 0.2 z at mid-depth.
* ``tests/test_solver3d.py``'s callback case (8x2 x 4 layers): the
  vertical profile, the transect, the 3D station and the accumulator on
  one seeded state in both packages, their values and their
  ``DiagnosticHDF5`` files over two evaluations; the 3D volume, tracer
  mass and overshoot monitors with ``export_to_hdf5=True`` likewise; and
  the test's own run through the port's ``iterate()`` with its checks.
* Detectors and the 2D station on a seeded 2D state: points inside cells,
  on a vertex and outside the mesh (the nearest centroid).
* The 2D monitors (volume, tracer mass, overshoot) through ``iterate()``
  with exports on (``export_diagnostics``): the same HDF5 series and
  checkpoint files in both (SSPRK33, two exports).

Tolerances: sampled values 1e-14 of their scale (the same numpy
arithmetic on the same gathered numbers; the interface z coordinates come
from each package's elementwise tensor code); the monitors' series and
the 2D run's checkpoints 1e-12 (host sums over fields that agree at
roundoff); times and shapes exactly."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu import solver2d as jsolver2d  # noqa: E402
from thetis_tpu.mesh.generation import RectangleMesh as JRect  # noqa: E402
from thetis_tpu.model import callback as jcb  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TSpace)
from thetis_tpu_torch.mesh.generation import (  # noqa: E402
    RectangleMesh as TRect)
from thetis_tpu_torch.model import callback as tcb  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402
from thetis_tpu_torch.model.flowsolver3d import (  # noqa: E402
    FlowSolver as TFlow)

F64 = torch.float64
RTOL = 1e-14
MON_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale


def same_series(a, b, rtol=RTOL):
    """Two DiagnosticHDF5 files: the same datasets, times equal."""
    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert sorted(fa) == sorted(fb)
        assert np.array_equal(fa["time"][:], fb["time"][:])
        for k in fb:
            close(fa[k][:], fb[k][:], rtol)
        return {k: fb[k].shape for k in fb}


# -- 3D --------------------------------------------------------------
OPTS3D = dict(timestep=30.0, simulation_export_time=300.0,
              simulation_end_time=300.0, no_exports=True,
              horizontal_viscosity=1.0, horizontal_diffusivity=1.0)


class Case3D:
    """test_solver3d.py::make_solver3d(nx=8, nz=4) in both packages,
    equations created, one seeded 3D state set in both."""

    def __init__(self, tmp_path, seed=0):
        nz, self.nz = 4, 4
        self.j = JFlow(JRect(8, 2, 20e3, 4e3), jnp.asarray(20.0), nz)
        self.t = TFlow(TRect(8, 2, 20e3, 4e3, device="cpu", dtype=F64),
                       20.0, nz)
        for s, d in ((self.j, "j"), (self.t, "t")):
            s.options.update(OPTS3D)
            s.options.output_directory = str(tmp_path / d)
            s.create_equations()
        rng = np.random.default_rng(seed)
        nc = self.j.mesh2d.nc
        shape3 = (nc, 3, nz, 2)
        self.state = {
            "elev_2d": 0.3 * rng.standard_normal((nc, 3)),
            "uv_3d": 0.2 * rng.standard_normal(shape3 + (2,)),
            "temp_3d": 10.0 + rng.standard_normal(shape3),
            "salt_3d": 35.0 + 0.1 * rng.standard_normal(shape3)}
        self.set_state(self.state)

    def set_state(self, st, time=0.0):
        for k, v in st.items():
            self.j.fields[k].data = jnp.asarray(v)
            self.t.fields[k].data = torch.as_tensor(v)
        self.j.simulation_time = self.t.simulation_time = time

    def both(self, name, *args, first=None, **kw):
        """Callback ``name`` in both packages (``first``: an argument
        before the solver, as the tracer monitors take their field)."""
        lead = () if first is None else (first,)
        return (getattr(jcb, name)(*lead, self.j, *args, **kw),
                getattr(tcb, name)(*lead, self.t, *args, **kw))


def test_timeseries_3d_recovers_a_linear_profile():
    """tests/test_3d.py:247-280 in both packages."""
    depth = 20.0
    out = []
    for flow, mesh, cb, arr in (
            (JFlow, JRect(6, 4, 1e3, 6e2), jcb, jnp.asarray),
            (TFlow, TRect(6, 4, 1e3, 6e2, device="cpu", dtype=F64), tcb,
             torch.as_tensor)):
        s = flow(mesh, arr(depth), 5)
        s.options.update(dict(
            timestep=10.0, simulation_export_time=10.0,
            simulation_end_time=10.0, no_exports=True,
            solve_temperature=True, solve_salinity=False))
        s.create_equations()
        sig = np.linspace(-depth, 0.0, 6)
        zn = np.stack([sig[:-1], sig[1:]], axis=-1)
        s.fields.temp_3d.data = arr(np.broadcast_to(
            15.0 + 0.2 * zn[None, None], (mesh.nc, 3, 5, 2)).copy())
        c = cb.TimeSeriesCallback3D(s, ["temp_3d"], 512.0, 333.0, -10.0,
                                    "sta")
        out.append(float(np.ravel(c()[0])[0]))
    assert abs(out[1] - 13.0) < 1e-10
    assert out[1] == pytest.approx(out[0], rel=RTOL, abs=0)


@pytest.mark.parametrize("which", ["profile", "transect", "timeseries3d"])
def test_3d_samplers_agree(tmp_path, which):
    case = Case3D(tmp_path, seed=1)
    if which == "profile":
        jc, tc = case.both("VerticalProfileCallback", ["temp_3d", "uv_3d"],
                           10e3, 2e3, "midpoint", export_to_hdf5=True,
                           append_to_log=False)
    elif which == "transect":
        jc, tc = case.both("TransectCallback", ["salt_3d", "uv_3d"],
                           [5e3, 10e3, 15e3, 19.9e3], [2e3, 1e3, 3e3, 0.1e3],
                           "axis", export_to_hdf5=True, append_to_log=False)
    else:
        jc, tc = case.both("TimeSeriesCallback3D", ["temp_3d", "uv_3d"],
                           7.3e3, 1.1e3, -6.0, "sta", export_to_hdf5=True,
                           append_to_log=False)
    assert tc.name == jc.name and tc.variable_names == jc.variable_names
    assert tc.array_dim == jc.array_dim
    for step in range(2):
        if step:
            rng = np.random.default_rng(2)
            st = {k: v + 0.01 * rng.standard_normal(v.shape)
                  for k, v in case.state.items()}
            case.set_state(st, time=300.0)
        for a, b in zip(tc(), jc()):
            close(a, b)
        jc.evaluate()
        tc.evaluate()
    fn = "diagnostic_" + jc.name.replace(" ", "_") + ".hdf5"
    shapes = same_series(tmp_path / "t" / fn, tmp_path / "j" / fn)
    assert shapes["time"] == (2, 1)


def test_3d_monitors_write_the_reference_s_series(tmp_path):
    case = Case3D(tmp_path, seed=3)
    pairs = [case.both("VolumeConservation3DCallback", export_to_hdf5=True,
                       append_to_log=False),
             case.both("TracerMassConservation3DCallback",
                       export_to_hdf5=True, append_to_log=False,
                       first="temp_3d"),
             case.both("TracerOvershootCallBack", export_to_hdf5=True,
                       append_to_log=False, first="salt_3d")]
    rng = np.random.default_rng(4)
    for step in range(3):
        st = {k: v + 0.01 * step * rng.standard_normal(v.shape)
              for k, v in case.state.items()}
        case.set_state(st, time=300.0 * step)
        for jc, tc in pairs:
            jc.evaluate()
            tc.evaluate()
    for jc, _ in pairs:
        fn = "diagnostic_" + jc.name.replace(" ", "_") + ".hdf5"
        assert same_series(tmp_path / "t" / fn, tmp_path / "j" / fn,
                           MON_RTOL)["time"] == (3, 1)


def test_accumulator_agrees(tmp_path):
    case = Case3D(tmp_path, seed=5)
    jc = jcb.AccumulatorCallback(
        lambda: float(np.asarray(case.j.fields.elev_2d.data).max()), case.j)
    tc = tcb.AccumulatorCallback(
        lambda: float(case.t.fields.elev_2d.data.max()), case.t)
    for step in range(4):
        st = dict(case.state, elev_2d=case.state["elev_2d"] * (1 + step))
        case.set_state(st, time=30.0 * step)
        jc.evaluate()
        tc.evaluate()
    assert tc.get_val() == jc.get_val() != 0.0
    assert not os.path.exists(tmp_path / "t" / "diagnostic_accumulator.hdf5")


def test_3d_callbacks_through_iterate(tmp_path):
    """tests/test_solver3d.py::test_3d_callbacks on the port: the callbacks
    evaluated at the exports of ``iterate()`` and their HDF5 series."""
    mesh = TRect(8, 2, 20e3, 4e3, device="cpu", dtype=F64)
    so = TFlow(mesh, TFunction(TSpace(mesh, "CG", 1)).assign(20.0), 4)
    so.options.update(OPTS3D)
    so.options.output_directory = str(tmp_path)
    t2d = TFunction(TSpace(mesh, "DG", 1)).interpolate(
        lambda x, y: 10.0 + 2.0 * x / 20e3)
    so.assign_initial_conditions(temp=t2d.data, salt=35.0)
    prof = tcb.VerticalProfileCallback(
        so, ["temp_3d", "uv_3d"], 10e3, 2e3, "midpoint",
        export_to_hdf5=True, append_to_log=False)
    trans = tcb.TransectCallback(
        so, ["salt_3d"], [5e3, 10e3, 15e3], [2e3, 2e3, 2e3], "axis",
        export_to_hdf5=True, append_to_log=False)
    acc = tcb.AccumulatorCallback(
        lambda: float(so.fields.elev_2d.data.max()), so)
    for c in (prof, trans, acc):
        so.add_callback(c)
    so.iterate()
    z, temp, uv = prof()
    assert len(z) == so.n_layers + 1
    assert z[0] == pytest.approx(-20.0, abs=0.5) and z[-1] > -1.0
    assert abs(temp.mean() - 11.0) < 1.5
    tvals = trans()
    assert len(tvals[0]) == 3 * (so.n_layers + 1)
    assert np.allclose(tvals[1], 35.0, atol=1e-6)
    assert acc.old_value is not None
    for c in (prof, trans):
        fn = tmp_path / ("diagnostic_" + c.name + ".hdf5")
        with h5py.File(fn) as f:
            assert f["time"].shape == (2, 1)  # t = 0 and the export


# -- 2D --------------------------------------------------------------
def solvers2d():
    js = jsolver2d.FlowSolver2d(JRect(6, 3, 6e3, 3e3), 10.0)
    tm = TRect(6, 3, 6e3, 3e3, device="cpu", dtype=F64)
    ts = FlowSolver2d(tm, 10.0)
    for s in (js, ts):
        s.options.no_exports = True
        s.create_function_spaces()
        s.create_fields()
    return js, ts


def test_detectors_and_2d_stations_agree():
    js, ts = solvers2d()
    rng = np.random.default_rng(6)
    elev = rng.standard_normal((js.mesh2d.nc, 3))
    uv = rng.standard_normal((js.mesh2d.nc, 3, 2))
    js.fields.elev_2d.data, js.fields.uv_2d.data = (jnp.asarray(elev),
                                                    jnp.asarray(uv))
    ts.fields.elev_2d.data, ts.fields.uv_2d.data = (torch.as_tensor(elev),
                                                    torch.as_tensor(uv))
    # inside cells, a mesh vertex, and a point outside the mesh
    pts = [[1234.5, 987.6], [3000.0, 1500.0], [5900.0, 2950.0],
           [-400.0, 1000.0]]
    jd = jcb.DetectorsCallback(js, pts, ["elev_2d", "uv_2d"], "gauges")
    td = tcb.DetectorsCallback(ts, pts, ["elev_2d", "uv_2d"], "gauges")
    assert np.array_equal(td.cell_ids, jd.cell_ids)
    assert np.array_equal(td.bary, jd.bary)
    assert td.array_dim == jd.array_dim == 3
    got, ref = td(), jd()
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        close(a, b)
    jt = jcb.TimeSeriesCallback2D(js, ["uv_2d"], 4321.0, 765.0, "st")
    tt = tcb.TimeSeriesCallback2D(ts, ["uv_2d"], 4321.0, 765.0, "st")
    assert tt.name == jt.name == "timeseries_st"
    close(tt()[0], jt()[0])


def monitored_2d(solver, outdir):
    o = solver.options
    o.swe_timestepper_type = "SSPRK33"
    o.timestep = 20.0
    o.simulation_export_time = 40.0
    o.simulation_end_time = 80.0
    o.output_directory = str(outdir)
    o.add_tracer_2d("tracer_2d", diffusivity=1.0)
    o.check_volume_conservation_2d = True
    o.check_tracer_conservation = True
    o.check_tracer_overshoot = True


def test_2d_monitors_write_the_reference_s_series(tmp_path):
    from thetis_tpu import RectangleMesh as JR

    js = jsolver2d.FlowSolver2d(JR(4, 2, 4e3, 2e3), 10.0)
    ts = FlowSolver2d(TRect(4, 2, 4e3, 2e3, device="cpu", dtype=F64), 10.0)
    for s, d in ((js, "j"), (ts, "t")):
        monitored_2d(s, tmp_path / d)
    x = js.mesh2d.coords_np[js.mesh2d.cells_np]  # the P1DG nodes
    elev = 0.1 * np.exp(-((x[..., 0] - 2e3) / 1e3) ** 2)
    tracer = 1.0 + np.exp(-((x[..., 1] - 1e3) / 500.0) ** 2)
    js.assign_initial_conditions(elev=jnp.asarray(elev),
                                 tracer_2d=jnp.asarray(tracer))
    ts.assign_initial_conditions(elev=torch.as_tensor(elev),
                                 tracer_2d=torch.as_tensor(tracer))
    js.iterate()
    ts.iterate()
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == files
    diags = [f for f in files if f.startswith("diagnostic_")]
    assert diags == ["diagnostic_tracer_2d_mass.hdf5",
                     "diagnostic_tracer_2d_overshoot.hdf5",
                     "diagnostic_volume2d.hdf5"]
    for fn in diags:
        assert same_series(tmp_path / "t" / fn, tmp_path / "j" / fn,
                           MON_RTOL)["time"] == (3, 1)
    for fn in sorted(os.listdir(tmp_path / "j" / "hdf5")):
        with h5py.File(tmp_path / "t" / "hdf5" / fn) as a, \
                h5py.File(tmp_path / "j" / "hdf5" / fn) as b:
            for k in b:
                close(a[k][:], b[k][:], MON_RTOL)
