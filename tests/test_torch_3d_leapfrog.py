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
  the per-tracer case and ROFI run it;
* ``per_tracer``: an open 8x4 rectangle x 3 layers with both tracers
  under different ``value`` boundaries, a temperature source and momentum
  ``symm``/``uv`` boundaries (each tracer on its own path): five steps;
* the Rhine ROFI example (``examples/rhineROFI/rhineROFI.py``) at
  ``coarse=16`` with 2 layers, built by both packages from one
  description (``chip_smoke.rofi_description``, the port's solver through
  ``interop.flowsolver3d_from_numpy``): three steps through
  ``iterate(update_forcings=...)``, the Kelvin-wave elevation set again
  each step.

Tolerance: rtol 1e-8 times each field's scale, as
``tests/test_torch_3d_gls.py`` (the closure's powers and the barotropic
Krylov solve amplify summation-order roundoff).  ROFI's start is
ill-conditioned for the closure: its salinity is uniform in the vertical,
so N^2 is roundoff and the sign of the buoyancy flux picks the psi
source's c3 at random; a relative change of 1e-15 in the start's
salinity moves psi by ~5e-6 and nu_v by ~4e-5 of scale in the port
alone.  There the fields the closure reaches (uv_3d, tke, psi and the
eddy coefficients) are held to a tenth of the port's own spread on the
eddy coefficients under a 1e-13 change of the start's salinity (measured
in the test: ~1.7e-4 of scale, so ~1.7e-5); the elevation, the 2D
velocity and the salinity to 1e-8."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from thetis_tpu import config as jconfig  # noqa: E402
from thetis_tpu.fem.functionspace import Function as JFunction  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.mesh.mesh2d import Mesh2d as JMesh2d  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu.utils.coordsys import (  # noqa: E402
    beta_plane_coriolis_params as j_beta)
from thetis_tpu_torch import config as tconfig  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_keys, state3d_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.mesh2d import Mesh2d as TMesh2d  # noqa: E402

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


# -- the Rhine ROFI example ------------------------------------------------
ROFI_STEPS = 3


@pytest.fixture(scope="module")
def rofi_run():
    coords, cells, markers = chip_smoke.rofi_mesh_arrays(16.0)
    d = chip_smoke.rofi_description(coords, cells, 2, ROFI_STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.physical_constants, "rho0", 1000.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1000.0)
        jm = JMesh2d(coords, cells, boundary_markers=markers,
                     name="rhine_rofi")
        tm = TMesh2d(coords, cells, boundary_markers=markers,
                     name="rhine_rofi", device="cpu", dtype=F64)
        kelvin = JFunction(JFS(jm, "CG", 1))
        kelvin.data = jnp.asarray(d["kelvin"](0.0))
        bnd = {w: {m: {k: kelvin if v == "kelvin" else v
                       for k, v in sp.items()} for m, sp in specs.items()}
               for w, specs in d["bnd"].items()}
        js = JFlow(jm, jnp.asarray(d["bathymetry"]), 2)
        js.options.update(jax_values(d["options"]))
        for which, specs in bnd.items():
            js.bnd_functions[which] = specs
        ts = flowsolver3d_from_numpy(tm, d["bathymetry"], 2, d["options"],
                                     bnd_functions=bnd)
        t_kelvin = ts.bnd_functions["shallow_water"][1]["elev"]
        assert all(ts.bnd_functions["shallow_water"][m]["elev"] is t_kelvin
                   for m in (1, 2, 3))
        ics = dict(elev=d["elev"], uv_2d=d["uv"], salt=d["salt"])
        js.assign_initial_conditions(**jax_values(ics))
        ts.assign_initial_conditions(**ics)

        def j_forcing(t):
            kelvin.data = jnp.asarray(d["kelvin"](t))

        def t_forcing(t):
            t_kelvin.data = torch.tensor(d["kelvin"](t))

        js.iterate(update_forcings=j_forcing)
        bathy_cell = d["bathymetry"][cells]
        fw0 = chip_smoke.rofi_freshwater(ts, bathy_cell)
        ts.iterate(update_forcings=t_forcing)
        fw1 = chip_smoke.rofi_freshwater(ts, bathy_cell)
        # the port again, its start's salinity changed by 1e-13 (relative:
        # above the roundoff that separates the two packages)
        again = flowsolver3d_from_numpy(tm, d["bathymetry"], 2,
                                        d["options"], bnd_functions=bnd)
        noise = np.random.default_rng(0).standard_normal(d["salt"].shape)
        again.assign_initial_conditions(**dict(
            ics, salt=d["salt"] * (1 + 1e-13 * noise)))
        a_kelvin = again.bnd_functions["shallow_water"][1]["elev"]
        a_kelvin.data = torch.tensor(d["kelvin"](0.0))

        def a_forcing(t):
            a_kelvin.data = torch.tensor(d["kelvin"](t))

        again.iterate(update_forcings=a_forcing)
    got = state3d_to_numpy(ts._get_state())
    spread = {k: np.abs(v - got[k]).max() for k, v in
              state3d_to_numpy(again._get_state()).items()}
    return dict(js=js, ts=ts, fw=(fw0, fw1), spread=spread, got=got,
                want={k: np.asarray(v) for k, v in
                      js._get_state().items()})


#: the fields the closure's start reaches in three steps
ROFI_CLOSURE = ("uv_3d", "tke_3d", "psi_3d", "nu_v_3d", "mu_v_3d")


def rofi_sensitivity(r):
    """The port's own spread on the eddy coefficients under the 1e-13
    change of the start's salinity, relative to their scale."""
    return max(r["spread"][k] / np.abs(r["got"][k]).max()
               for k in ("nu_v_3d", "mu_v_3d"))


def test_rofi_start_is_ill_conditioned(rofi_run):
    """What the looser tolerance below rests on: the start's roundoff
    alone moves the eddy coefficients far above 1e-8."""
    assert rofi_sensitivity(rofi_run) > 1e-6


@pytest.mark.parametrize("key", ("elev", "uv", "salt_3d") + ROFI_CLOSURE)
def test_rofi_iterate_matches_reference(rofi_run, key):
    """1e-8 of scale, or for the fields the closure reaches a tenth of the
    port's own spread on the eddy coefficients, whichever is larger."""
    g, w = rofi_run["got"][key], rofi_run["want"][key]
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    rtol = RTOL
    if key in ROFI_CLOSURE:
        rtol = max(RTOL, 0.1 * rofi_sensitivity(rofi_run))
    np.testing.assert_allclose(g, w, rtol=0.0,
                               atol=rtol * np.abs(w).max())


def test_rofi_fields_and_diagnostics(rofi_run):
    """The example's own checks (rhineROFI.py:234-246) and the w and the
    monitors of the last export, against the reference's."""
    ts, js = rofi_run["ts"], rofi_run["js"]
    assert ts.iteration == js.iteration == ROFI_STEPS
    salt = rofi_run["got"]["salt_3d"]
    assert salt.min() > -0.01 and salt.max() < 32.01
    fw0, fw1 = rofi_run["fw"]
    assert abs(fw1 - fw0) / max(abs(fw0), 1.0) < 0.05
    w_ref = np.asarray(js.fields.w_3d.data)
    np.testing.assert_allclose(ts.fields.w_3d.data.numpy(), w_ref,
                               rtol=RTOL, atol=RTOL * np.abs(w_ref).max())
    assert sorted(ts.callbacks["export"]) == sorted(js.callbacks["export"])


_DRIFT = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", sys.argv[1] == "64")
import jax.numpy as jnp
import torch
import chip_smoke
from thetis_tpu import config as jc
from thetis_tpu.fem.functionspace import Function, FunctionSpace
from thetis_tpu.mesh.mesh2d import Mesh2d
from thetis_tpu.model.flowsolver3d import FlowSolver
torch.set_num_threads(2)
jc.physical_constants["rho0"] = 1000.0
coarse, layers, steps = 4.0, 4, 100
coords, cells, markers = chip_smoke.rofi_mesh_arrays(coarse)
d = chip_smoke.rofi_description(coords, cells, layers, steps)
dtype = torch.float64 if sys.argv[1] == "64" else torch.float32
s, forcing, bc = chip_smoke.rofi_solver("cpu", dtype, coarse=coarse,
                                        layers=layers, steps=steps)
fw0 = chip_smoke.rofi_freshwater(s, bc)
s.iterate(update_forcings=forcing)
port = (chip_smoke.rofi_freshwater(s, bc) - fw0) / fw0
jm = Mesh2d(coords, cells, boundary_markers=markers, name="rhine_rofi")
kelvin = Function(FunctionSpace(jm, "CG", 1))
kelvin.data = jnp.asarray(d["kelvin"](0.0))
js = FlowSolver(jm, jnp.asarray(d["bathymetry"]), layers)
js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in d["options"].items()})
for which, specs in d["bnd"].items():
    js.bnd_functions[which] = {m: {k: kelvin if v == "kelvin" else v
                                   for k, v in sp.items()}
                               for m, sp in specs.items()}
js.assign_initial_conditions(elev=jnp.asarray(d["elev"]),
                             uv_2d=jnp.asarray(d["uv"]),
                             salt=jnp.asarray(d["salt"]))


def fresh():
    salt = np.asarray(js.fields.salt_3d.data, dtype=np.float64)
    elev = np.asarray(js.fields.elev_2d.data, dtype=np.float64)
    depth = (bc + elev).mean(axis=1)
    return float(((1.0 - salt / 32.0).mean(axis=(1, 2, 3)) * depth
                  * jm.cell_area_np).sum())


def update(t):
    kelvin.data = jnp.asarray(d["kelvin"](t))


f0 = fresh()
js.iterate(update_forcings=update)
print("DRIFT", port, (fresh() - f0) / f0)
"""


@pytest.mark.slow
def test_rofi_f32_freshwater_drift_against_reference():
    """ROFI at coarse 4 with 4 layers, 100 steps, each package in f32 and
    in f64 (each run in a process of its own, JAX's x64 switch set for
    it): in f64 both keep the example's freshwater diagnostic, and agree;
    in f32 both lose some (the ocean's salinity drifts by roundoff and its
    volume multiplies it), the port no more than the reference."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    drift = {}
    for bits in ("32", "64"):
        out = subprocess.run(
            [sys.executable, "-c", _DRIFT, bits], cwd=root,
            capture_output=True, text=True, timeout=1800,
            env=dict(os.environ, PYTHONPATH=root))
        assert out.returncode == 0, out.stderr[-3000:]
        line = [x for x in out.stdout.splitlines() if x.startswith("DRIFT")]
        drift[bits] = tuple(float(v) for v in line[-1].split()[1:])
    print(f"freshwater change (port, reference): f32 {drift['32']}, "
          f"f64 {drift['64']}")
    port64, ref64 = drift["64"]
    assert abs(port64) < 0.05 and abs(port64 - ref64) < 1e-8
    port32, ref32 = drift["32"]
    assert abs(port32) <= abs(ref32)
