"""The fixed mesh and the unsplit 2D coupling (ROADMAP A7d),
``thetis_tpu_torch`` against ``thetis_tpu`` (f64, CPU), each alone, three
steps from the same numpy inputs on an open 8x4 rectangle x 3 layers
(a bed sloping from 20 to 10 m, salinity and temperature on the packed
path, the tracer limiter, an ``elev`` and a ``flux`` 2D boundary):

* ``fixed``: ``use_ale_moving_mesh=False``: the 3D mesh stays at the
  rest position (geometry at zero elevation, no mesh velocity), the free
  surface moves in the 2D system only;
* ``unsplit``: ``use_modesplit_2d=False``: the full
  ``ShallowWaterEquations`` as the 2D mode, forced by the depth-averaged
  internal pressure gradient; no ``split_residual`` in the state.

Tolerance: rtol 1e-8 times each field's scale, as
``tests/test_torch_3d_slice.py``; the export-time w of ``_set_state``
likewise."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ModeSplit2DEquations, ShallowWaterEquations)
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_keys, state3d_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402

F64 = torch.float64
RTOL = 1e-8
NX, NY, NZ = 8, 4, 3
LX, LY = 40e3, 20e3
NSTEPS = 3
CASES = {"fixed": dict(use_ale_moving_mesh=False),
         "unsplit": dict(use_modesplit_2d=False)}
BND = {"shallow_water": {1: {"elev": 0.1}, 2: {"flux": -50.0}}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def options(case):
    opts = dict(timestepper_type="SSPRK22", solve_salinity=True,
                solve_temperature=True, coriolis_frequency=1.15e-4,
                timestep=60.0, simulation_export_time=180.0,
                simulation_end_time=180.0, no_exports=True,
                use_limiter_for_tracers=True, horizontal_diffusivity=10.0,
                horizontal_viscosity=5.0)
    opts.update(CASES[case])
    return opts


def initial_state(jm):
    rng = np.random.default_rng(3)
    xc = jm.coords_np[jm.cells_np]
    salt = np.broadcast_to((20 + 10 * xc[..., 0] / LX)[:, :, None, None],
                           (jm.nc, 3, NZ, 2)).copy()
    return dict(elev=0.05 * np.cos(xc[..., 0] / LX * np.pi), salt=salt,
                temp=12 + rng.random((jm.nc, 3, NZ, 2)))


def port_solver(case, **extra):
    tm = tgen.RectangleMesh(NX, NY, LX, LY, device="cpu", dtype=F64)
    bathy = 20.0 - 10.0 * tm.coords_np[:, 0] / LX
    ts = flowsolver3d_from_numpy(tm, bathy, NZ, dict(options(case), **extra),
                                 bnd_functions=BND)
    ts.assign_initial_conditions(**initial_state(tm))
    return ts


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    case = request.param
    jm = jgen.RectangleMesh(NX, NY, LX, LY)
    bathy = 20.0 - 10.0 * jm.coords_np[:, 0] / LX
    js = JFlow(jm, jnp.asarray(bathy), NZ)
    js.options.update(options(case))
    js.bnd_functions["shallow_water"] = {m: dict(s) for m, s in
                                         BND["shallow_water"].items()}
    js.assign_initial_conditions(**{k: jnp.asarray(v) for k, v in
                                    initial_state(jm).items()})
    j_state = js._get_state()
    j_out = js._advance_n_jit(j_state, js._gather_swe_fields(),
                              js._gather_bnd_sw(), n=NSTEPS)
    ts = port_solver(case)
    t_state = ts._get_state()
    t_fields, t_bnd = ts._gather_swe_fields(), ts._gather_bnd_sw()
    out = t_state
    for _ in range(NSTEPS):
        out = ts._step(out, t_fields, t_bnd)
    return dict(case=case, js=js, ts=ts, j_state=j_state, t_state=t_state,
                t_fields=t_fields, t_bnd=t_bnd, j_out=j_out, out=out,
                want={k: np.asarray(v) for k, v in j_out.items()},
                got=state3d_to_numpy(out))


def close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("key", state3d_keys())
def test_three_steps_match_reference(run, key):
    if key not in run["want"]:
        assert key == "split_residual" and run["case"] == "unsplit"
        assert key not in run["got"]
        return
    close(run["got"][key], run["want"][key])


def test_state_keys_follow_the_options(run):
    keys = state3d_keys(run["ts"].options)
    assert tuple(sorted(run["t_state"])) == tuple(sorted(run["j_state"])) \
        == tuple(sorted(run["out"])) == keys
    assert ("split_residual" in keys) is (run["case"] == "fixed")


def test_export_time_w_matches_reference(run):
    """``_set_state``'s diagnostic w, on the rest geometry for the fixed
    mesh."""
    run["js"]._set_state(run["j_out"])
    run["ts"]._set_state(run["out"])
    close(run["ts"].fields.w_3d.data.numpy(),
          np.asarray(run["js"].fields.w_3d.data))


def test_the_option_was_in_force(run):
    ts, state = run["ts"], run["t_state"]
    geom0, int_pg, src = ts._pre_fn(state)
    Dn = geom0["Delta_nodes"]
    if run["case"] == "fixed":
        # the rest geometry, whatever the elevation
        rest = ts.bathy_cell[:, :, None] / NZ
        assert float((Dn - rest).abs().max()) < 1e-12
        assert isinstance(ts.eq_sw, ModeSplit2DEquations)
        assert src is state["split_residual"]
    else:
        assert type(ts.eq_sw) is ShallowWaterEquations
        dav = ts.asm3d.vertical_integral(int_pg, geom0, average=True)
        assert torch.equal(src, dav) and float(src.abs().max()) > 0
        assert float((Dn.sum(-1) - ts.bathy_cell - state["elev"])
                     .abs().max()) < 1e-12
    moved = np.abs(run["got"]["elev"] - state["elev"].numpy()).max()
    assert moved > 1e-3


def test_unsplit_without_baroclinicity_has_no_2d_source():
    """The unsplit mode with no baroclinic formulation forces the 2D mode
    with nothing: ``pre`` returns no source and the step runs."""
    ts = port_solver("unsplit", use_baroclinic_formulation=False)
    state = ts._get_state()
    _, int_pg, src = ts._pre_fn(state)
    assert int_pg is None and src is None
    out = ts._step(state, ts._gather_swe_fields(), ts._gather_bnd_sw())
    assert sorted(out) == sorted(state)
    for k, v in out.items():
        assert bool(torch.isfinite(v).all()), k
