"""The 3D solver's lifecycle, ``thetis_tpu_torch`` against ``thetis_tpu``
(f64, CPU): ``iterate()`` with exports, callbacks and the conservation
monitors, ``_set_state``'s diagnostic ``w_3d``, ``compute_volume_3d`` /
``compute_tracer_mass_3d``, the CFL time-step arithmetic of
``set_time_step`` under every ``dt_mode``, and the explicit subcycled 2D
mode of ``dt_mode='split'``.

Tolerances: fields after ``iterate()`` and after the split steps rtol 1e-8
of each field's scale (as ``tests/test_torch_3d_slice.py``); volumes and
tracer masses rtol 1e-12 (host sums of the same numbers); the time-step
arithmetic rtol 1e-14 (Python floats on both sides); counters equal."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu import config as jconfig  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu.utils.coordsys import (  # noqa: E402
    beta_plane_coriolis_params as j_beta)
from thetis_tpu_torch import config as tconfig  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_to_numpy)
from thetis_tpu_torch.kernels import ringmv  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.model import callback as tcb  # noqa: E402
from thetis_tpu_torch.utils.constant import Constant  # noqa: E402

F64 = torch.float64
NX = NY = 6
NZ = 3
L, DEPTH = 1600e3, 1600.0
FIELDS = ("elev_2d", "uv_2d", "uv_3d", "w_3d", "salt_3d", "temp_3d",
          "tke_3d", "psi_3d", "split_residual_2d")
MONITORS = ("volume3d", "temp_3d mass", "temp_3d overshoot")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_options(opts):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in opts.items()}


def bench_options(cor):
    """The bench's 3D options, 4 steps with an export every 2, the
    monitors on."""
    return dict(
        timestepper_type="SSPRK22", solve_salinity=False,
        solve_temperature=True, constant_salinity=35.0,
        use_baroclinic_formulation=True,
        use_implicit_vertical_diffusion=True, use_bottom_friction=True,
        coriolis_frequency=cor, vertical_viscosity=1e-3,
        vertical_diffusivity=1e-5, horizontal_viscosity=0.5 * L / NX / 200.0,
        horizontal_diffusivity=30.0, equation_of_state_type="linear",
        timestep=300.0, simulation_export_time=600.0,
        simulation_end_time=1200.0, no_exports=True,
        check_volume_conservation_3d=True,
        check_temperature_conservation=True,
        check_temperature_overshoot=True,
        # salinity is not solved: its monitors must not be registered
        check_salinity_conservation=True, check_salinity_overshoot=True)


def bench_temperature(mesh):
    x = mesh.coords_np[mesh.cells_np]
    y_pert = 0.1 * L * np.sin(2 * np.pi * x[..., 0] / L)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L / 2)
    sigma = np.linspace(-DEPTH, 0.0, NZ + 1)
    z_nodes = np.stack([sigma[:-1], sigma[1:]], axis=-1)
    return t2d[:, :, None, None] + 8.2e-3 * (z_nodes[None, None] + DEPTH / 2)


def bench_elevation(mesh):
    """A 10 cm bump, so that the volume is not the resting one."""
    x = mesh.coords_np
    return 0.1 * np.exp(-(((x[:, 0] - L / 2) / 4e5) ** 2)
                        - ((x[:, 1] - L / 2) / 4e5) ** 2)


def port_bench(cor):
    tm = tgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x",
                                    device="cpu", dtype=F64)
    ts = flowsolver3d_from_numpy(tm, DEPTH, NZ, bench_options(cor))
    ts.assign_initial_conditions(elev=bench_elevation(tm),
                                 temp=bench_temperature(tm))
    return ts


def monitor_values(solver):
    """Every export callback evaluated once more, by name."""
    return {name: cb() for name, cb in solver.callbacks["export"].items()}


@pytest.fixture(scope="module")
def run():
    """``iterate()`` of both solvers from the same numpy inputs, each
    counting its ``export_func`` calls; and the port's ``iterate()`` again
    with an ``update_forcings`` callable (the step-at-a-time path)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.physical_constants, "rho0", 1020.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        jm = jgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x")
        f0, beta = j_beta(37.5)
        cor = f0 + beta * (jm.coords_np[:, 1] - L / 2)
        js = JFlow(jm, jnp.asarray(DEPTH), NZ)
        js.options.update(jax_options(bench_options(cor)))
        js.assign_initial_conditions(
            elev=jnp.asarray(bench_elevation(jm)),
            temp=jnp.asarray(bench_temperature(jm)))
        j_start = dict(volume=js.compute_volume_3d(),
                       mass=js.compute_tracer_mass_3d("temp_3d"))
        j_exports = []
        js.iterate(export_func=lambda: j_exports.append(
            (js.iteration, js.simulation_time, js.i_export)))

        ts = port_bench(cor)
        t_start = dict(volume=ts.compute_volume_3d(),
                       mass=ts.compute_tracer_mass_3d("temp_3d"))
        t_exports = []
        ringmv.reset_launches()
        ts.iterate(export_func=lambda: t_exports.append(
            (ts.iteration, ts.simulation_time, ts.i_export)))

        tf = port_bench(cor)
        forced = []
        tf.iterate(update_forcings=forced.append)
        yield dict(js=js, ts=ts, tf=tf, j_start=j_start, t_start=t_start,
                   j_exports=j_exports, t_exports=t_exports, forced=forced,
                   launches=ringmv.launches("ring_mv"))


@pytest.mark.parametrize("name", FIELDS)
def test_iterate_fields_match_reference(run, name):
    want = np.asarray(run["js"].fields[name].data)
    got = run["ts"].fields[name].data.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    if name != "salt_3d":
        assert np.abs(want).max() > 0


def test_iterate_counters_match_reference(run):
    js, ts = run["js"], run["ts"]
    assert (ts.iteration, ts.i_export) == (js.iteration, js.i_export) == (4, 2)
    assert ts.simulation_time == js.simulation_time == 1200.0
    assert ts.dt == js.dt == 300.0
    assert ts.dt_2d == js.dt_2d and ts.M_modesplit == js.M_modesplit == 1


def test_export_func_called_as_often(run):
    assert run["t_exports"] == run["j_exports"] == [(2, 600.0, 1),
                                                    (4, 1200.0, 2)]


def test_monitors_registered_as_in_reference(run):
    names = tuple(run["ts"].callbacks["export"])
    assert names == tuple(run["js"].callbacks["export"]) == MONITORS
    assert "timestep" not in run["ts"].callbacks


@pytest.mark.parametrize("name", MONITORS)
def test_monitor_values_match_reference(run, name):
    got = monitor_values(run["ts"])[name]
    want = monitor_values(run["js"])[name]
    assert len(got) == len(want)
    t0 = run["ts"].callbacks["export"][name].initial_value
    j0 = run["js"].callbacks["export"][name].initial_value
    np.testing.assert_allclose(t0, j0, rtol=1e-12)
    # value(s) first, then differences from the start, which are held to
    # the value's scale
    scale = np.abs(np.asarray(j0)).max()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9 * scale)


def test_volume_and_mass_match_reference(run):
    for key in ("volume", "mass"):
        np.testing.assert_allclose(run["t_start"][key], run["j_start"][key],
                                   rtol=1e-12)
    js, ts = run["js"], run["ts"]
    np.testing.assert_allclose(ts.compute_volume_3d(),
                               js.compute_volume_3d(), rtol=1e-12)
    np.testing.assert_allclose(ts.compute_tracer_mass_3d("temp_3d"),
                               js.compute_tracer_mass_3d("temp_3d"),
                               rtol=1e-12)
    # the bump is in the volume, and the run conserved it
    rest = DEPTH * L * L
    assert run["t_start"]["volume"] - rest > 1e-6 * rest
    assert abs(ts.compute_volume_3d() / run["t_start"]["volume"] - 1) < 1e-12


def test_update_forcings_path_equals_scan_path(run):
    """A step at a time with the forcings gathered again gives the bits of
    the interval-at-a-time loop, and is told the time of every step's
    end."""
    ts, tf = run["ts"], run["tf"]
    assert run["forced"] == [300.0, 600.0, 900.0, 1200.0]
    assert (tf.iteration, tf.i_export, tf.simulation_time) == (4, 2, 1200.0)
    for name in FIELDS:
        assert torch.equal(tf.fields[name].data, ts.fields[name].data), name


def test_iterate_continues_from_its_state(run):
    """A second ``iterate()`` to a later end time goes on from the fields
    and counters of the first: no second initial export, monitors not
    registered twice."""
    tf = run["tf"]
    seen = []
    tf.add_callback(_Probe(tf, seen))
    tf.options.simulation_end_time = 1800.0
    tf.iterate()
    assert (tf.iteration, tf.i_export, tf.simulation_time) == (6, 3, 1800.0)
    assert seen == [1800.0]
    assert tuple(tf.callbacks["export"]) == MONITORS + ("probe",)


class _Probe(tcb.DiagnosticCallback):
    name = "probe"
    variable_names = ["time"]

    def __init__(self, solver, seen):
        super().__init__(solver, append_to_log=False)
        self.seen = seen

    def __call__(self):
        self.seen.append(self.solver_obj.simulation_time)
        return (self.solver_obj.simulation_time,)


def test_iterate_ran_on_the_cpu_without_kernels(run):
    assert run["launches"] == 0


def test_set_state_does_not_alias_w(run):
    ts = run["ts"]
    s = ts._get_state()
    w = ts.fields.w_3d.data.clone()
    ts._set_state(s)
    assert torch.equal(ts.fields.w_3d.data, w)  # a function of the state
    assert set(state3d_to_numpy(s)) == set(ts._get_state())


# -- the time-step arithmetic ---------------------------------------------
def sloped_solvers(options):
    """Both solvers on a 5x4 rectangle with a sloped bed, fields made, no
    equation built."""
    jm = jgen.RectangleMesh(5, 4, 9e3, 6e3)
    tm = tgen.RectangleMesh(5, 4, 9e3, 6e3, device="cpu", dtype=F64)
    bathy = 12.0 + 30.0 * jm.coords_np[:, 1] / 6e3
    js = JFlow(jm, jnp.asarray(bathy), 5)
    js.options.update(options)
    js.create_fields()
    ts = flowsolver3d_from_numpy(tm, bathy, 5, options)
    ts.create_fields()
    return js, ts


@pytest.mark.parametrize("stepper", ["SSPRK22", "CrankNicolson"])
@pytest.mark.parametrize("automatic", [False, True], ids=["fixed", "auto"])
@pytest.mark.parametrize("dt_mode", ["3d", "2d", "split"])
def test_set_time_step_matches_reference(dt_mode, automatic, stepper):
    js, ts = sloped_solvers(dict(
        dt_mode=dt_mode, use_automatic_timestep=automatic,
        timestepper_type=stepper, timestep=47.0, timestep_2d=3.1,
        simulation_export_time=500.0, horizontal_velocity_scale=0.7,
        vertical_velocity_scale=2e-3, horizontal_viscosity_scale=15.0,
        cfl_2d=0.8, cfl_3d=0.9, no_exports=True))
    bounds = {
        "compute_dt_2d": 0.7, "compute_dt_h_advection": 0.7,
        "compute_dt_v_advection": 2e-3, "compute_dt_diffusion": 15.0}
    for fn, scale in bounds.items():
        got = getattr(ts, fn)(scale)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, getattr(js, fn)(scale), rtol=1e-14,
                                   err_msg=fn)
    np.testing.assert_allclose(ts.compute_dx_factor(), js.compute_dx_factor(),
                               rtol=1e-14)
    np.testing.assert_allclose(ts.compute_dz_factor(), js.compute_dz_factor(),
                               rtol=1e-14)
    np.testing.assert_allclose(ts.set_time_step(), js.set_time_step(),
                               rtol=1e-14)
    np.testing.assert_allclose(ts.dt, js.dt, rtol=1e-14)
    np.testing.assert_allclose(ts.dt_2d, js.dt_2d, rtol=1e-14)
    assert ts.M_modesplit == js.M_modesplit
    assert (ts.M_modesplit > 1) == (dt_mode == "split")
    # dt divides the export interval, dt_2d divides dt
    np.testing.assert_allclose(
        500.0 / ts.dt, round(500.0 / ts.dt), rtol=1e-12)
    np.testing.assert_allclose(ts.dt_2d * ts.M_modesplit, ts.dt, rtol=1e-14)


def test_fixed_time_step_must_be_positive():
    _, ts = sloped_solvers(dict(dt_mode="2d", timestep=0.0, no_exports=True))
    with pytest.raises(ValueError, match="timestep"):
        ts.set_time_step()


def test_initialize_picks_the_2d_stepper():
    """``initialize`` calls ``set_time_step`` for every mode but the plain
    '3d' one, and takes the explicit SSPRK33 2D stepper at ``dt_2d`` only
    when the 2D mode is subcycled."""
    kinds = {}
    for mode in ("3d", "2d", "split"):
        tm = tgen.RectangleMesh(3, 2, 9e3, 6e3, device="cpu", dtype=F64)
        ts = flowsolver3d_from_numpy(tm, 20.0, 2, dict(
            dt_mode=mode, timestep=60.0, timestep_2d=10.0,
            simulation_export_time=600.0, no_exports=True))
        ts.initialize()
        kinds[mode] = (type(ts.swe_stepper).__name__, ts.swe_stepper.dt,
                       ts.M_modesplit)
    assert kinds == {"3d": ("CrankNicolson", 60.0, 1),
                     "2d": ("CrankNicolson", 60.0, 1),
                     "split": ("SSPRK33", 10.0, 6)}


# -- dt_mode='split' ------------------------------------------------------
def split_options():
    """The barotropic wave of ``tests/test_modesplit_dt.py``."""
    return dict(
        timestep=60.0, timestep_2d=10.0, dt_mode="split",
        simulation_export_time=600.0, simulation_end_time=600.0,
        no_exports=True, solve_salinity=False, solve_temperature=False,
        use_baroclinic_formulation=False,
        use_implicit_vertical_diffusion=False, use_bottom_friction=False,
        horizontal_viscosity=1.0)


@pytest.fixture(scope="module")
def split_run():
    lx = 20e3
    jm = jgen.RectangleMesh(12, 2, lx, 4e3)
    tm = tgen.RectangleMesh(12, 2, lx, 4e3, device="cpu", dtype=F64)
    elev0 = 0.3 * np.exp(-(((jm.coords_np[:, 0] - lx / 2) / 3e3) ** 2))
    js = JFlow(jm, jnp.asarray(20.0), 4)
    js.options.update(split_options())
    js.assign_initial_conditions(elev=jnp.asarray(elev0))
    j_out = js._advance_n_jit(js._get_state(), js._gather_swe_fields(),
                              js._gather_bnd_sw(), n=2)
    ts = flowsolver3d_from_numpy(tm, 20.0, 4, split_options())
    ts.assign_initial_conditions(elev=elev0)
    ringmv.reset_launches()
    out = ts.advance_n(ts._get_state(), ts._gather_swe_fields(),
                       ts._gather_bnd_sw(), 2)
    return dict(js=js, ts=ts, got=state3d_to_numpy(out),
                want={k: np.asarray(v) for k, v in j_out.items()},
                launches=(ringmv.launches("ring_mv"),
                          ringmv.launches("block_diag_mv")))


@pytest.mark.parametrize("key", ["elev", "uv", "uv_3d", "split_residual",
                                 "salt_3d", "temp_3d", "tke_3d", "psi_3d"])
def test_two_split_steps_match_reference(split_run, key):
    want, got = split_run["want"][key], split_run["got"][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * max(np.abs(want).max(), 1e-300))


def test_split_mode_subcycles_the_explicit_2d_mode(split_run):
    js, ts = split_run["js"], split_run["ts"]
    assert ts.M_modesplit == js.M_modesplit == 6
    assert ts.dt_2d == js.dt_2d == 10.0
    assert type(ts.swe_stepper).__name__ == "SSPRK33"
    assert split_run["launches"] == (0, 0)
    assert np.abs(split_run["got"]["uv"]).max() > 1e-3  # the wave moved


# -- what was unported until A10 ----------------------------------------
def test_exports_raise_naming_a10(tmp_path):
    """The exports, ``load_state`` and the monitors' HDF5 series raised
    naming A10 until it was ported; with the reference's default
    ``no_exports=False`` they run: ``iterate()`` writes the series and the
    checkpoints, ``load_state(0)`` restores the start, and the volume
    monitor writes its HDF5 series (parity in
    ``test_torch_io_restart3d.py`` and ``test_torch_io_callbacks.py``)."""
    # 4x2: nc (16) differs from nv (15), so no DG array reads as CG1
    tm = tgen.RectangleMesh(4, 2, 9e3, 6e3, device="cpu", dtype=F64)
    ts = flowsolver3d_from_numpy(
        tm, 20.0, 2, dict(timestep=60.0, simulation_export_time=60.0,
                          simulation_end_time=60.0,
                          output_directory=str(tmp_path)))
    assert ts.options.no_exports is False  # the reference's default
    ts.initialize()
    ts.assign_initial_conditions(elev=0.1)
    start = {k: v.clone() for k, v in ts._get_state().items()}
    ts.iterate()
    assert ts.iteration == 1
    assert sorted(os.listdir(tmp_path / "Elevation2d")) == [
        "Elevation2d.pvd", "Elevation2d_00000.vtu", "Elevation2d_00001.vtu"]
    ts.load_state(0)
    assert ts.simulation_time == 0.0 and ts.iteration == 0
    for k, v in ts._get_state().items():
        assert torch.equal(v, start[k]), k
    cb = tcb.VolumeConservation3DCallback(ts, export_to_hdf5=True)
    cb.evaluate()
    assert (tmp_path / "diagnostic_volume3d.hdf5").exists()


def test_constant_boundary_value_is_gathered():
    tm = tgen.RectangleMesh(3, 2, 9e3, 6e3, device="cpu", dtype=F64)
    ts = flowsolver3d_from_numpy(tm, 20.0, 2, dict(no_exports=True))
    c = Constant(0.25)
    ts.bnd_functions["shallow_water"] = {1: {"elev": c}, 2: {"un": 0.0}}
    b = ts._gather_bnd_sw()
    assert sorted(b) == [1, 2] and float(b[1]["elev"]) == 0.25
    c.assign(0.5)  # read again at every gather
    assert float(ts._gather_bnd_sw()[1]["elev"]) == 0.5
    assert b[2]["un"].dtype == F64


def test_run_script_in_the_reference_form():
    """The reference's Kato-Phillips script (``tests/test_katophillips.py``)
    with its imports changed to the port's and the mesh asked for on the
    CPU: a CG1 bathymetry ``Function``, options set as attributes,
    ``create_fields`` before the initial conditions, ``iterate()``."""
    from thetis_tpu_torch import Function, FunctionSpace
    from thetis_tpu_torch.mesh.generation import PeriodicRectangleMesh
    from thetis_tpu_torch.model.flowsolver3d import FlowSolver

    mesh2d = PeriodicRectangleMesh(3, 2, 7500.0, 5000.0, direction="x",
                                   device="cpu", dtype=F64)
    P1 = FunctionSpace(mesh2d, "CG", 1)
    bath = Function(P1).assign(50.0)
    so = FlowSolver(mesh2d, bath, 5)
    o = so.options
    o.timestep = 60.0
    o.simulation_export_time = 120.0
    o.simulation_end_time = 240.0 - 1e-9
    o.no_exports = True
    o.use_nonlinear_equations = False
    o.solve_salinity = True
    o.solve_temperature = False
    o.use_bottom_friction = False
    o.use_turbulence = True
    o.vertical_viscosity = 1.3e-6
    o.vertical_diffusivity = 1.4e-7
    o.wind_stress = np.array([0.1, 0.0])
    o.check_salinity_conservation = True
    so.create_fields()
    sigma = so.extruded.sigma_np
    s_if = 35.0 - 0.01 * (-50.0 * (1.0 - sigma))
    salt3 = np.broadcast_to(np.stack([s_if[:-1], s_if[1:]], axis=-1),
                            (mesh2d.nc, 3, 5, 2)).copy()
    so.assign_initial_conditions(salt=salt3)
    so.iterate()
    assert (so.iteration, so.i_export) == (4, 2)
    assert tuple(so.callbacks["export"]) == ("salt_3d mass",)
    value, rel = so.callbacks["export"]["salt_3d mass"]()
    assert value > 0 and abs(rel) < 1e-6  # the step conserves salt
    for name in ("tke_3d", "psi_3d", "nu_v_3d", "mu_v_3d", "w_3d", "uv_3d"):
        assert bool(torch.isfinite(so.fields[name].data).all()), name
    assert float(so.fields.nu_v_3d.data.max()) > 1e-6
