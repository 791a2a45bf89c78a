"""The LeapFrogAM3 3D stepper (ROADMAP A7d), ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU), from the same numpy inputs:

* ``packed_gls``: the GLS workload of ``tests/test_torch_3d_gls.py`` (the
  bench's channel at 6x6 periodic cells x 3 layers refined toward the
  surface) under half its wind stress, with salinity and temperature on
  the packed path and tke/psi advected: five steps, every state key, the
  ``*_lf_old`` history included.  The tracer limiter is off here: with it
  (or the full wind) the closure amplifies summation-order roundoff to
  ~1e-7 of scale in five steps, under SSPRK22 as under LeapFrogAM3 (the
  limiter's min/max branches and the closure's floors flip at roundoff);
  the per-tracer case and ROFI (``tests/test_torch_3d_rofi.py``) run it;
* ``per_tracer``: an open 8x4 rectangle x 3 layers with both tracers
  under different ``value`` boundaries, a temperature source and momentum
  ``symm``/``uv`` boundaries (each tracer on its own path): five steps.

Tolerance: rtol 1e-8 times each field's scale, as
``tests/test_torch_3d_gls.py`` (the closure's powers and the barotropic
Krylov solve amplify summation-order roundoff)."""
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
    flowsolver3d_from_numpy, state3d_keys, state3d_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402

F64 = torch.float64
RTOL = 1e-8
NSTEPS = 5
# the GLS workload (tests/test_torch_3d_gls.py)
NX = NY = 6
NZ = 3
L, DEPTH = 1600e3, 1600.0
SIGMA = np.array([0.0, 0.99, 0.9995, 1.0])
# the open rectangle of the per-tracer case
OX, OY, OLX, OLY = 8, 4, 40e3, 20e3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_values(d):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def compare(got, want, key):
    g, w = got[key], want[key]
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=RTOL,
                               atol=RTOL * max(np.abs(w).max(), 1e-300))


def packed_gls_case():
    jm = jgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x")
    tm = tgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x",
                                    device="cpu", dtype=F64)
    f0, beta = j_beta(37.5)
    cor = f0 + beta * (jm.coords_np[:, 1] - L / 2)
    opts = dict(
        timestepper_type="LeapFrogAM3", solve_salinity=True,
        solve_temperature=True, use_baroclinic_formulation=True,
        use_implicit_vertical_diffusion=True, use_bottom_friction=True,
        coriolis_frequency=cor, vertical_viscosity=1e-3,
        vertical_diffusivity=1e-5, horizontal_viscosity=0.5 * L / NX / 200.0,
        horizontal_diffusivity=30.0, use_limiter_for_tracers=False,
        timestep=300.0, simulation_export_time=24 * 3600.0,
        simulation_end_time=24 * 3600.0, no_exports=True,
        use_turbulence=True, use_turbulence_advection=True,
        wind_stress=np.array([0.05, 0.015]))
    x = jm.coords_np[jm.cells_np]
    y_pert = 0.1 * L * np.sin(2 * np.pi * x[..., 0] / L)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L / 2)
    z = -DEPTH * (1.0 - SIGMA)
    z_nodes = np.stack([z[:-1], z[1:]], axis=-1)[None, None]
    temp = t2d[:, :, None, None] + 8.2e-3 * (z_nodes + DEPTH / 2)
    salt = (35.0 - 1e-3 * (z_nodes + DEPTH / 2)
            + 0.5 * np.cos(2 * np.pi * x[..., 0] / L)[:, :, None, None])
    return dict(jm=jm, tm=tm, bathy=DEPTH, opts=opts, bnd={},
                extrude=dict(sigma=SIGMA),
                ics=dict(elev=np.zeros((jm.nc, 3)), temp=temp, salt=salt))


def per_tracer_case():
    jm = jgen.RectangleMesh(OX, OY, OLX, OLY)
    tm = tgen.RectangleMesh(OX, OY, OLX, OLY, device="cpu", dtype=F64)
    rng = np.random.default_rng(11)
    xv = jm.coords_np
    opts = dict(
        timestepper_type="LeapFrogAM3", solve_salinity=True,
        solve_temperature=True, coriolis_frequency=1.15e-4,
        horizontal_viscosity=5.0, horizontal_diffusivity=10.0,
        use_limiter_for_tracers=True, timestep=60.0,
        simulation_export_time=300.0, simulation_end_time=300.0,
        no_exports=True,
        temperature_source_3d=1e-5 * rng.random((jm.nc, 3, NZ, 2)))
    bnd = {"shallow_water": {1: {"elev": 0.1}, 2: {"flux": -50.0}},
           "momentum": {1: {"symm": None},
                        2: {"uv": np.array([-50.0 / (OLY * 10.0), 0.0])}},
           "salt": {1: {"value": 32.0}, 2: {"value": 0.0}},
           "temp": {1: {"value": 10.0}, 2: {"value": 15.0}}}
    xc = jm.coords_np[jm.cells_np]
    salt = np.broadcast_to((20 + 10 * xc[..., 0] / OLX)[:, :, None, None],
                           (jm.nc, 3, NZ, 2)).copy()
    return dict(jm=jm, tm=tm, bathy=20.0 - 10.0 * xv[:, 0] / OLX, opts=opts,
                bnd=bnd, extrude=None,
                ics=dict(elev=0.05 * np.cos(xc[..., 0] / OLX * np.pi),
                         salt=salt,
                         temp=12 + rng.random((jm.nc, 3, NZ, 2))))


CASES = {"packed_gls": packed_gls_case, "per_tracer": per_tracer_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def lf_run(request):
    """Both solvers from the same description; the reference's five steps
    in one compiled call, the port's five ``_step`` calls."""
    c = CASES[request.param]()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.physical_constants, "rho0", 1020.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        js = JFlow(c["jm"], jnp.asarray(c["bathy"]), NZ,
                   extrude_options=c["extrude"])
        js.options.update(jax_values(c["opts"]))
        for which, specs in c["bnd"].items():
            js.bnd_functions[which] = {m: jax_values(s)
                                       for m, s in specs.items()}
        ts = flowsolver3d_from_numpy(c["tm"], c["bathy"], NZ, c["opts"],
                                     extrude_options=c["extrude"],
                                     bnd_functions=c["bnd"])
        js.assign_initial_conditions(**jax_values(c["ics"]))
        ts.assign_initial_conditions(**c["ics"])
        j_state = js._get_state()
        j_out = js._advance_n_jit(j_state, js._gather_swe_fields(),
                                  js._gather_bnd_sw(), n=NSTEPS)
        t_state = ts._get_state()
        t_fields, t_bnd = ts._gather_swe_fields(), ts._gather_bnd_sw()
        start = {k: v.clone() for k, v in t_state.items()}
        out = t_state
        for _ in range(NSTEPS):
            out = ts._step(out, t_fields, t_bnd)
        yield dict(case=request.param, js=js, ts=ts, j_state=j_state,
                   t_state=t_state, start=start, t_fields=t_fields,
                   t_bnd=t_bnd, want={k: np.asarray(v)
                                      for k, v in j_out.items()},
                   got=state3d_to_numpy(out))


LF_KEYS = sorted(set(state3d_keys(packed_gls_case()["opts"]))
                 | set(state3d_keys(per_tracer_case()["opts"])))


@pytest.mark.parametrize("key", LF_KEYS)
def test_five_leapfrog_steps_match_reference(lf_run, key):
    if key not in lf_run["want"]:
        assert key not in lf_run["got"]
        return
    compare(lf_run["got"], lf_run["want"], key)


def test_history_keys_and_their_seed(lf_run):
    """The state's keys follow the options; the history starts as the
    current state, ``uv_lf_old`` as the total velocity."""
    ts, t = lf_run["ts"], lf_run["t_state"]
    assert tuple(sorted(t)) == tuple(sorted(lf_run["j_state"])) \
        == state3d_keys(ts.options)
    for k in t:
        np.testing.assert_array_equal(t[k].numpy(),
                                      np.asarray(lf_run["j_state"][k]))
    total = t["uv_3d"] + t["uv"][:, :, None, None, :]
    assert torch.equal(t["uv_lf_old"], total)
    for k in ("salt", "temp") + (("tke", "psi") if "tke_lf_old" in t
                                 else ()):
        assert torch.equal(t[f"{k}_lf_old"], t[f"{k}_3d"])


def test_path_taken(lf_run):
    """``packed_gls`` advects both tracers in one packed residual and tke
    and psi alone; ``per_tracer`` each tracer with its boundaries."""
    ts = lf_run["ts"]
    gls = lf_run["case"] == "packed_gls"
    assert ("tke_lf_old" in lf_run["t_state"]) is gls
    assert bool(ts.eq_salt.open_markers) is not gls
    moved = {k: np.abs(lf_run["got"][k] - lf_run["start"][k].numpy()).max()
             for k in ("salt_3d", "temp_3d", "uv_3d")}
    assert min(moved.values()) > 1e-6, moved
    if gls:
        assert lf_run["got"]["tke_3d"].max() > 10 * ts.gls.options.k_min


def test_step_wrote_into_no_state_tensor(lf_run):
    for k, v in lf_run["start"].items():
        assert torch.equal(lf_run["t_state"][k], v), k


def test_iterate_equals_advance_n(lf_run):
    """``iterate()`` builds the state once, so the history runs on across
    its exports: it ends on the bits of ``advance_n`` over the same
    steps."""
    ts = lf_run["ts"]
    o = ts.options
    o.simulation_export_time = 2 * ts.dt
    o.simulation_end_time = NSTEPS * ts.dt
    f, b = lf_run["t_fields"], lf_run["t_bnd"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        want = ts.advance_n(ts._get_state(), f, b, 6)
        ts.iterate()
    got = ts._get_state()
    assert ts.iteration == 6
    for k in ("uv_3d", "salt_3d", "temp_3d", "elev", "uv"):
        assert torch.equal(got[k], want[k]), k
