"""The ported 3D slice as a whole: the bench's baroclinic channel
configuration (``bench.py::build_workload_3d``: SSPRK22 ALE, temperature
only, linear EOS, weak flux-consistent w, packed tracer + ones
consistency, vertex limiter, implicit vertical viscosity/diffusion with
law-of-wall bottom friction, beta-plane CG1 Coriolis, ModeSplit 2D mode
by assembled CN) at 6x6 periodic cells x 3 layers, f64 on the CPU.  Two
steps of the port's ``FlowSolver._step`` against one
``_advance_n_jit(..., n=2)`` of the reference, from the same numpy
initial state (the bench's temperature field), entered through the same
calls as the bench.

Tolerance: rtol 1e-8 times each field's scale, on every state key: both
packages take the same Krylov path in the barotropic solve, and the
limiter's branches do not flip at roundoff, so the fields differ by
summation-order roundoff only (measured ~1e-14 relative)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thetis_tpu import config as jconfig  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu.utils.coordsys import (  # noqa: E402
    beta_plane_coriolis_params as j_beta)
from thetis_tpu_torch import config as tconfig  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    STATE3D_KEYS, flowsolver3d_from_numpy, state3d_from_numpy,
    state3d_to_numpy)
from thetis_tpu_torch.kernels import ringmv, tridiag  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.utils.coordsys import (  # noqa: E402
    beta_plane_coriolis_params as t_beta)

F64 = torch.float64
NX = NY = 6
NZ = 3
L, DEPTH = 1600e3, 1600.0   # bench.py:122-123


def bench_options(cor):
    """bench.py:133-150, with exports off."""
    return dict(
        timestepper_type="SSPRK22", solve_salinity=False,
        solve_temperature=True, constant_salinity=35.0,
        use_baroclinic_formulation=True,
        use_implicit_vertical_diffusion=True, use_bottom_friction=True,
        coriolis_frequency=cor, vertical_viscosity=1e-3,
        vertical_diffusivity=1e-5, horizontal_viscosity=0.5 * L / NX / 200.0,
        horizontal_diffusivity=30.0, equation_of_state_type="linear",
        timestep=300.0, simulation_export_time=24 * 3600.0,
        simulation_end_time=24 * 3600.0, no_exports=True)


def bench_temperature(mesh):
    """bench.py:152-162."""
    x = mesh.coords_np[mesh.cells_np]
    y_pert = 0.1 * L * np.sin(2 * np.pi * x[..., 0] / L)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L / 2)
    sigma = np.linspace(-DEPTH, 0.0, NZ + 1)
    z_nodes = np.stack([sigma[:-1], sigma[1:]], axis=-1)
    return t2d[:, :, None, None] + 8.2e-3 * (z_nodes[None, None] + DEPTH / 2)


def port_solver(options=None):
    tm = tgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x",
                                    device="cpu", dtype=F64)
    f0, beta = t_beta(37.5)
    cor = f0 + beta * (tm.coords_np[:, 1] - L / 2)
    opts = bench_options(cor)
    opts.update(options or {})
    return tm, flowsolver3d_from_numpy(tm, DEPTH, NZ, opts)


@pytest.fixture(scope="module")
def run():
    """Both solvers from the same numpy inputs; the reference's two steps
    in one compiled call, the port's two ``_step`` calls."""
    with pytest.MonkeyPatch.context() as mp:
        # bench.py:121 sets rho0 globally; restore it in both packages
        mp.setitem(jconfig.physical_constants, "rho0", 1020.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        jm = jgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x")
        f0, beta = j_beta(37.5)
        cor = f0 + beta * (jm.coords_np[:, 1] - L / 2)
        js = JFlow(jm, jnp.asarray(DEPTH), NZ)
        js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v)
                           for k, v in bench_options(cor).items()})
        js.initialize()
        temp0 = bench_temperature(jm)
        js.assign_initial_conditions(elev=jnp.zeros((jm.nc, 3)),
                                     temp=jnp.asarray(temp0))
        j_state = js._get_state()
        j_fields = js._gather_swe_fields()
        j_out = js._advance_n_jit(j_state, j_fields, {}, n=2)

        tm, ts = port_solver()
        ts.initialize()
        ts.assign_initial_conditions(elev=np.zeros((tm.nc, 3)), temp=temp0)
        t_state = ts._get_state()
        t_fields = ts._gather_swe_fields()
        ringmv.reset_launches()
        tridiag.reset_launches()
        out = t_state
        for _ in range(2):
            out = ts._step(out, t_fields, {})
        launches = (ringmv.launches("ring_mv")
                    + ringmv.launches("block_diag_mv") + tridiag.launches())
        yield dict(js=js, ts=ts, j_state=j_state, t_state=t_state,
                   j_fields=j_fields, t_fields=t_fields,
                   want={k: np.asarray(v) for k, v in j_out.items()},
                   got=state3d_to_numpy(out), launches=launches)


@pytest.mark.parametrize("key", STATE3D_KEYS)
def test_two_steps_match_reference(run, key):
    want, got = run["want"][key], run["got"][key]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * max(np.abs(want).max(), 1e-300))


def test_same_state_keys_and_initial_state(run):
    assert sorted(run["j_state"]) == sorted(run["t_state"]) == list(
        STATE3D_KEYS)
    for k in STATE3D_KEYS:
        np.testing.assert_array_equal(run["t_state"][k].numpy(),
                                      np.asarray(run["j_state"][k]))


def test_swe_fields_match_reference(run):
    jf, tf = run["j_fields"], run["t_fields"]
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]),
                                   rtol=1e-15)


def test_optional_forcings_gather_like_reference():
    """The 2D and 3D forcings the bench leaves off (wind stress, 2D
    momentum and volume sources, a 3D momentum source, the 2D quadratic
    drag without 3D bottom friction) reach the step's fields as in the
    reference."""
    rng = np.random.default_rng(5)
    jm = jgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x")
    extra = dict(
        wind_stress=rng.normal(size=(jm.nv, 2)) * 0.1,
        momentum_source_2d=rng.normal(size=(jm.nc, 3, 2)) * 1e-6,
        volume_source_2d=1e-7,
        momentum_source_3d=rng.normal(size=(jm.nc, 3, NZ, 2, 2)) * 1e-7,
        quadratic_drag_coefficient=2.5e-3, use_bottom_friction=False)
    f0, beta = j_beta(37.5)
    opts = bench_options(f0 + beta * (jm.coords_np[:, 1] - L / 2))
    opts.update(extra)
    js = JFlow(jm, jnp.asarray(DEPTH), NZ)
    js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                           else v) for k, v in opts.items()})
    js.initialize()
    jf = js._gather_swe_fields()
    _, ts = port_solver(extra)
    ts.initialize()
    tf = ts._gather_swe_fields()
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]),
                                   rtol=1e-15)


def test_steps_moved_the_state(run):
    """Not a comparison of two no-ops: the barotropic mode, the baroclinic
    velocity and the temperature all changed."""
    s0 = state3d_to_numpy(run["t_state"])
    got = run["got"]
    for k, floor in (("elev", 1e-4), ("uv", 1e-5), ("uv_3d", 1e-5),
                     ("temp_3d", 1e-6), ("split_residual", 1e-9)):
        assert np.abs(got[k] - s0[k]).max() > floor, k
    np.testing.assert_array_equal(got["salt_3d"], s0["salt_3d"])


def test_cpu_run_launched_no_kernel(run):
    assert run["launches"] == 0  # CPU tensors take the plain versions


def test_advance_n_is_the_step_loop(run):
    ts = run["ts"]
    out = ts.advance_n(run["t_state"], run["t_fields"], {}, 2)
    for k in STATE3D_KEYS:
        np.testing.assert_array_equal(out[k].numpy(), run["got"][k])


def test_state3d_interop_roundtrip(run):
    s = state3d_to_numpy(run["t_state"])
    back = state3d_to_numpy(state3d_from_numpy(s, "cpu", F64))
    for k in STATE3D_KEYS:
        np.testing.assert_array_equal(back[k], s[k])
    s.pop("tke_3d")
    with pytest.raises(KeyError):
        state3d_from_numpy(s, "cpu", F64)


UNPORTED = {
    "leapfrog": dict(timestepper_type="LeapFrogAM3"),
    "gls": dict(use_turbulence=True),
    "smagorinsky": dict(use_smagorinsky_viscosity=True),
    "split_dt": dict(dt_mode="split"),
    "automatic_dt": dict(use_automatic_timestep=True),
    "fixed_mesh": dict(use_ale_moving_mesh=False),
    "quadratic_head": dict(use_quadratic_pressure=True),
    "quadratic_density": dict(use_quadratic_density=True),
    "no_modesplit": dict(use_modesplit_2d=False),
    "tracer_source": dict(temperature_source_3d=1e-6),
}


@pytest.mark.parametrize("name", sorted(UNPORTED) + ["bc_3d"])
def test_unported_options_raise(name):
    _, ts = port_solver(UNPORTED.get(name))
    if name == "bc_3d":
        ts.bnd_functions["temp"] = {1: {"value": 10.0}}
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ts.initialize()


def test_single_stage_stepper_runs():
    """The 3D default stepper (one forward ALE stage per step) takes the
    same path with the second stage left out: one step stays finite and
    runs both tridiagonal solves (on the CPU as plain versions)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        tm, ts = port_solver(dict(timestepper_type="CrankNicolson"))
        ts.initialize()
        ts.assign_initial_conditions(temp=bench_temperature(tm))
        out = ts._step(ts._get_state(), ts._gather_swe_fields(), {})
    for k, v in out.items():
        assert bool(torch.isfinite(v).all()), k
