"""One full 3D step of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64,
CPU) under options that ``tests/test_torch_3d_slice.py``'s one
configuration leaves off, each from the bench's 6x6x3 set-up:

* ``full_eos``: salinity and temperature both solved, the Jackett
  equation of state;
* ``mass_pc``: a non-assembled barotropic preconditioner (the matrix-free
  Krylov path of the 2D CrankNicolson solve, restart 24);
* ``limited_velocity``: the vertex limiter on the velocity as well;
* ``open_boundary``: a non-periodic rectangle with an elevation condition
  on one side (a non-empty ``bnd_sw``).

Tolerance: rtol 1e-8 times each field's scale on every state key, as the
slice test."""
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
    STATE3D_KEYS, flowsolver3d_from_numpy, state3d_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402

F64 = torch.float64
NX = NY = 6
NZ = 3
L, DEPTH = 1600e3, 1600.0
CASES = {
    "full_eos": dict(solve_salinity=True, equation_of_state_type="full"),
    "mass_pc": dict(barotropic_preconditioner="mass"),
    "limited_velocity": dict(use_limiter_for_velocity=True),
    "open_boundary": {},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_options(cor):
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


def initial_fields(mesh):
    """The bench's temperature, a salinity that freshens toward the
    surface and along x, and a 10 cm bump of the free surface."""
    x = mesh.coords_np[mesh.cells_np]
    y_pert = 0.1 * L * np.sin(2 * np.pi * x[..., 0] / L)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L / 2)
    sigma = np.linspace(-DEPTH, 0.0, NZ + 1)
    z_nodes = np.stack([sigma[:-1], sigma[1:]], axis=-1)[None, None]
    temp = t2d[:, :, None, None] + 8.2e-3 * (z_nodes + DEPTH / 2)
    salt = (35.0 - 1e-3 * (z_nodes + DEPTH / 2)
            + 0.5 * np.cos(2 * np.pi * x[..., 0] / L)[:, :, None, None])
    xv = mesh.coords_np
    elev = 0.1 * np.exp(-(((xv[:, 0] - L / 2) / 4e5) ** 2)
                        - ((xv[:, 1] - L / 2) / 4e5) ** 2)
    return elev, temp, salt


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    case = request.param
    is_open = case == "open_boundary"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.physical_constants, "rho0", 1020.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        if is_open:
            jm = jgen.RectangleMesh(NX, NY, L, L)
            tm = tgen.RectangleMesh(NX, NY, L, L, device="cpu", dtype=F64)
        else:
            jm = jgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x")
            tm = tgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x",
                                            device="cpu", dtype=F64)
        f0, beta = j_beta(37.5)
        cor = f0 + beta * (jm.coords_np[:, 1] - L / 2)
        opts = bench_options(cor)
        opts.update(CASES[case])
        elev, temp, salt = initial_fields(jm)

        js = JFlow(jm, jnp.asarray(DEPTH), NZ)
        js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in opts.items()})
        ts = flowsolver3d_from_numpy(tm, DEPTH, NZ, opts)
        if is_open:
            js.bnd_functions["shallow_water"] = {1: {"elev": 0.05}}
            ts.bnd_functions["shallow_water"] = {1: {"elev": 0.05}}
        js.assign_initial_conditions(elev=jnp.asarray(elev),
                                     temp=jnp.asarray(temp),
                                     salt=jnp.asarray(salt))
        ts.assign_initial_conditions(elev=elev, temp=temp, salt=salt)
        j_bnd, t_bnd = js._gather_bnd_sw(), ts._gather_bnd_sw()
        j_state = js._get_state()
        j_out = js._advance_n_jit(j_state, js._gather_swe_fields(), j_bnd,
                                  n=1)
        t_state = ts._get_state()
        out = ts._step(t_state, ts._gather_swe_fields(), t_bnd)
        yield dict(case=case, js=js, ts=ts, t_bnd=t_bnd, j_bnd=j_bnd,
                   start=state3d_to_numpy(t_state),
                   want={k: np.asarray(v) for k, v in j_out.items()},
                   got=state3d_to_numpy(out))


@pytest.mark.parametrize("key", STATE3D_KEYS)
def test_one_step_matches_reference(run, key):
    want, got = run["want"][key], run["got"][key]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * max(np.abs(want).max(), 1e-300))


def test_the_option_was_in_force(run):
    """Each case took the path it names."""
    case, ts, js = run["case"], run["ts"], run["js"]
    moved = {k: np.abs(run["got"][k] - run["start"][k]).max()
             for k in ("salt_3d", "temp_3d", "uv_3d", "elev")}
    assert moved["temp_3d"] > 1e-6 and moved["uv_3d"] > 1e-5
    if case == "full_eos":
        assert type(ts.equation_of_state).__name__ == type(
            js.equation_of_state).__name__ == "JackettEquationOfState"
        assert moved["salt_3d"] > 1e-6
    else:
        assert moved["salt_3d"] == 0.0
    assembled = case != "mass_pc"
    assert ts.swe_stepper.assembled_solve is assembled
    assert ts.swe_stepper.params.gmres_restart == (6 if assembled else 24)
    assert hasattr(ts, "tracer_limiter")
    assert ts.options.use_limiter_for_velocity is (case == "limited_velocity")
    if case == "open_boundary":
        assert sorted(run["t_bnd"]) == sorted(run["j_bnd"]) == [1]
        assert float(run["t_bnd"][1]["elev"]) == 0.05
    else:
        assert run["t_bnd"] == {} == run["j_bnd"]
