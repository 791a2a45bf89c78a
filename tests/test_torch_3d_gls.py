"""The 3D step with the GLS turbulence closure, ``thetis_tpu_torch``
against ``thetis_tpu`` (f64, CPU), from the same numpy inputs:

* the bench's baroclinic channel (``tests/test_torch_3d_slice.py``) at
  6x6 periodic cells x 3 layers with ``use_turbulence=True`` (k-epsilon,
  Canuto A), a wind stress and layers refined toward the surface (0.8 m
  on top: on the bench's uniform 533 m layers no wind gives a shear whose
  production exceeds the dissipation, and tke never leaves its floor): two
  steps of the port's ``_step`` against one ``_advance_n_jit(n=2)`` of the
  reference, with and without ``use_turbulence_advection``;
* the Kato-Phillips wind-entrainment column of
  ``tests/test_katophillips.py`` (3x2 periodic cells, 20 layers, salt
  stratification N0 = 0.01 1/s, u* = 0.01 m/s, linear equations, no bottom
  friction): three steps against the reference, and, marked ``slow``, the
  port's own 4 h run through ``iterate()`` held to the reference test's
  bound on the mixed-layer depth (10% of 1.05 u* sqrt(t / N0)).

Tolerance: rtol 1e-8 times each field's scale on every state key, the
lagged eddy coefficients ``nu_v_3d``/``mu_v_3d`` included (the fields
differ by summation-order roundoff, which the barotropic Krylov solve and
the closure's powers amplify)."""
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
from thetis_tpu_torch.equations import turbulence as tturb  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_from_numpy, state3d_keys,
    state3d_to_numpy)
from thetis_tpu_torch.kernels import ringmv, tridiag  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402

F64 = torch.float64
NX = NY = 6
NZ = 3
L, DEPTH = 1600e3, 1600.0
#: interface distribution, bottom to surface: layers of 1584, 15.2 and 0.8 m
SIGMA = np.array([0.0, 0.99, 0.9995, 1.0])
GLS_KEYS = state3d_keys(dict(use_turbulence=True))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_options(opts):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in opts.items()}


def bench_options(cor, advect):
    """The bench's 3D options (exports off) plus the closure and a wind
    stress of 0.1 N/m^2."""
    return dict(
        timestepper_type="SSPRK22", solve_salinity=False,
        solve_temperature=True, constant_salinity=35.0,
        use_baroclinic_formulation=True,
        use_implicit_vertical_diffusion=True, use_bottom_friction=True,
        coriolis_frequency=cor, vertical_viscosity=1e-3,
        vertical_diffusivity=1e-5, horizontal_viscosity=0.5 * L / NX / 200.0,
        horizontal_diffusivity=30.0, equation_of_state_type="linear",
        timestep=300.0, simulation_export_time=24 * 3600.0,
        simulation_end_time=24 * 3600.0, no_exports=True,
        use_turbulence=True, use_turbulence_advection=advect,
        wind_stress=np.array([0.1, 0.03]))


def bench_temperature(mesh):
    x = mesh.coords_np[mesh.cells_np]
    y_pert = 0.1 * L * np.sin(2 * np.pi * x[..., 0] / L)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L / 2)
    z = -DEPTH * (1.0 - SIGMA)
    z_nodes = np.stack([z[:-1], z[1:]], axis=-1)
    return t2d[:, :, None, None] + 8.2e-3 * (z_nodes[None, None] + DEPTH / 2)


def compare_keys(got, want, key, floors=None):
    """rtol 1e-8 of the field's scale: its largest magnitude, or the
    ``floors`` entry where the field is zero but for roundoff."""
    g, w = got[key], want[key]
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    scale = max(np.abs(w).max(), (floors or {}).get(key, 1e-300))
    np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8 * scale)


@pytest.fixture(scope="module", params=[False, True],
                ids=["column_only", "advected"])
def bench_run(request):
    advect = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.physical_constants, "rho0", 1020.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1020.0)
        jm = jgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x")
        f0, beta = j_beta(37.5)
        cor = f0 + beta * (jm.coords_np[:, 1] - L / 2)
        opts = bench_options(cor, advect)
        js = JFlow(jm, jnp.asarray(DEPTH), NZ,
                   extrude_options=dict(sigma=SIGMA))
        js.options.update(jax_options(opts))
        js.initialize()
        temp0 = bench_temperature(jm)
        js.assign_initial_conditions(elev=jnp.zeros((jm.nc, 3)),
                                     temp=jnp.asarray(temp0))
        j_state = js._get_state()
        j_out = js._advance_n_jit(j_state, js._gather_swe_fields(), {}, n=2)

        tm = tgen.PeriodicRectangleMesh(NX, NY, L, L, direction="x",
                                        device="cpu", dtype=F64)
        ts = flowsolver3d_from_numpy(tm, DEPTH, NZ, opts,
                                     extrude_options=dict(sigma=SIGMA))
        ts.initialize()
        ts.assign_initial_conditions(elev=np.zeros((tm.nc, 3)), temp=temp0)
        t_state = ts._get_state()
        t_fields = ts._gather_swe_fields()
        start = {k: v.clone() for k, v in t_state.items()}
        calls = []
        mp.setattr(tturb, "tridiag_solve",
                   lambda *a: calls.append(a[3].shape) or
                   tridiag.tridiag_solve(*a))
        ringmv.reset_launches()
        tridiag.reset_launches()
        out = t_state
        for _ in range(2):
            out = ts._step(out, t_fields, {})
        launches = (ringmv.launches("ring_mv")
                    + ringmv.launches("block_diag_mv") + tridiag.launches())
        yield dict(ts=ts, j_state=j_state, t_state=t_state, start=start,
                   t_fields=t_fields, calls=list(calls), launches=launches,
                   want={k: np.asarray(v) for k, v in j_out.items()},
                   got=state3d_to_numpy(out))


@pytest.mark.parametrize("key", GLS_KEYS)
def test_two_gls_steps_match_reference(bench_run, key):
    compare_keys(bench_run["got"], bench_run["want"], key)


def test_gls_state_keys_and_initial_state(bench_run):
    assert tuple(sorted(bench_run["j_state"])) == tuple(
        sorted(bench_run["t_state"])) == GLS_KEYS
    for k in GLS_KEYS:
        np.testing.assert_array_equal(bench_run["t_state"][k].numpy(),
                                      np.asarray(bench_run["j_state"][k]))


def test_closure_did_something(bench_run):
    """Not a comparison of two closures at rest: the wind raised tke and
    the eddy viscosity off their floors, and the eddy coefficients differ
    from the start's."""
    o = bench_run["ts"].gls.options
    got = bench_run["got"]
    assert got["tke_3d"].max() > 10 * o.k_min
    assert got["nu_v_3d"].max() > 100 * o.visc_min
    assert got["mu_v_3d"].max() > 100 * o.diff_min
    assert got["psi_3d"].max() > 10 * o.psi_min


def test_step_wrote_into_no_state_tensor(bench_run):
    for k, v in bench_run["start"].items():
        assert torch.equal(bench_run["t_state"][k], v), k


def test_four_column_solves_a_step(bench_run):
    """Two steps: per step the velocity solve (both components on shared
    coefficients), the temperature solve, and the closure's k and psi
    solves.  On the CPU each takes the plain version: no kernel
    launches."""
    nc = NX * NY * 2
    col = (nc, 3, NZ + 1)
    assert bench_run["calls"] == [(2,) + col, col, col, col] * 2
    assert bench_run["launches"] == 0


def test_gls_advance_n_is_the_step_loop(bench_run):
    ts = bench_run["ts"]
    out = ts.advance_n(bench_run["t_state"], bench_run["t_fields"], {}, 2)
    assert tuple(sorted(out)) == GLS_KEYS
    for k in GLS_KEYS:
        np.testing.assert_array_equal(out[k].numpy(), bench_run["got"][k])


def test_gls_state_interop(bench_run):
    s = state3d_to_numpy(bench_run["t_state"])
    o = bench_run["ts"].options
    back = state3d_to_numpy(state3d_from_numpy(s, "cpu", F64, options=o))
    for k in GLS_KEYS:
        np.testing.assert_array_equal(back[k], s[k])
    with pytest.raises(KeyError):  # the key set follows the options
        state3d_from_numpy(s, "cpu", F64)
    s.pop("nu_v_3d")
    with pytest.raises(KeyError):
        state3d_from_numpy(s, "cpu", F64, options=o)


def test_gls_options_carried_from_reference():
    """A reference ``GLSModelOptions`` in the options dict arrives as the
    port's own class with the same attributes."""
    from thetis_tpu.equations.turbulence import GLSModelOptions as JOpt

    jo = JOpt(closure_name="k-omega", stability_function_name="Cheng",
              k_min=2e-6)
    tm = tgen.RectangleMesh(2, 2, L, L, device="cpu", dtype=F64)
    ts = flowsolver3d_from_numpy(tm, DEPTH, NZ, dict(
        use_turbulence=True, turbulence_model_options=jo, no_exports=True))
    to = ts.options.turbulence_model_options
    assert type(to) is tturb.GLSModelOptions
    assert vars(to) == vars(jo)
    ts.create_equations()
    assert ts.gls.options is to and to.p == -1.0
    np.testing.assert_array_equal(ts.fields.nu_v_3d.data.numpy(),
                                  np.full((tm.nc, 3, NZ, 2), jo.visc_min))


# -- Kato-Phillips --------------------------------------------------------
KP_DEPTH, KP_LAYERS, KP_US, KP_N0 = 50.0, 20, 0.01, 0.01


def kato_phillips_options(rho0, t_end):
    return dict(
        timestep=60.0, simulation_export_time=3600.0,
        simulation_end_time=t_end - 1e-9, no_exports=True,
        use_nonlinear_equations=False, solve_salinity=True,
        solve_temperature=False, constant_temperature=10.0,
        use_implicit_vertical_diffusion=True, use_bottom_friction=False,
        use_turbulence=True, use_baroclinic_formulation=True,
        vertical_viscosity=1.3e-6, vertical_diffusivity=1.4e-7,
        wind_stress=np.array([rho0 * KP_US**2, 0.0]))


def kato_phillips_salt(nc, rho0, g):
    """Linear salinity stratification: rho' = beta (S - S_ref),
    dS/dz = -N0^2 rho0 / (g beta)."""
    salt_grad = -(KP_N0**2) * rho0 / g / 0.77
    z_if = -KP_DEPTH * (1.0 - np.linspace(0.0, 1.0, KP_LAYERS + 1))
    s_if = 35.0 + salt_grad * z_if
    s_layers = np.stack([s_if[:-1], s_if[1:]], axis=-1)
    return np.broadcast_to(s_layers[None, None],
                           (nc, 3, KP_LAYERS, 2)).copy(), z_if


def kato_phillips_port(t_end):
    g = float(tconfig.physical_constants["g_grav"])
    rho0 = float(tconfig.physical_constants["rho0"])
    tm = tgen.PeriodicRectangleMesh(3, 2, 7500.0, 5000.0, direction="x",
                                    device="cpu", dtype=F64)
    ts = flowsolver3d_from_numpy(tm, KP_DEPTH, KP_LAYERS,
                                 kato_phillips_options(rho0, t_end))
    salt, z_if = kato_phillips_salt(tm.nc, rho0, g)
    ts.assign_initial_conditions(salt=salt)
    return ts, z_if


@pytest.fixture(scope="module")
def kp_run():
    g = float(jconfig.physical_constants["g_grav"])
    rho0 = float(jconfig.physical_constants["rho0"])
    assert rho0 == float(tconfig.physical_constants["rho0"])
    jm = jgen.PeriodicRectangleMesh(3, 2, 7500.0, 5000.0, direction="x")
    js = JFlow(jm, jnp.asarray(KP_DEPTH), KP_LAYERS)
    js.options.update(jax_options(kato_phillips_options(rho0, 4 * 3600.0)))
    salt, _ = kato_phillips_salt(jm.nc, rho0, g)
    js.assign_initial_conditions(salt=jnp.asarray(salt))
    j_out = js._advance_n_jit(js._get_state(), js._gather_swe_fields(), {},
                              n=3)
    ts, _ = kato_phillips_port(4 * 3600.0)
    out = ts.advance_n(ts._get_state(), ts._gather_swe_fields(), {}, 3)
    return dict(want={k: np.asarray(v) for k, v in j_out.items()},
                got=state3d_to_numpy(out), ts=ts)


@pytest.mark.parametrize("key", GLS_KEYS)
def test_kato_phillips_three_steps_match_reference(kp_run, key):
    # the flow is horizontally uniform: the free surface stays flat but
    # for the 2D solve's roundoff (1e-11 m), so it is held to a micrometre
    compare_keys(kp_run["got"], kp_run["want"], key, floors={"elev": 1e-6})


def test_kato_phillips_wind_reaches_the_closure(kp_run):
    """Three steps in, the surface node's psi and eddy viscosity have left
    their floors (tke follows some ten steps later) and the bed is at
    rest."""
    got, o = kp_run["got"], kp_run["ts"].gls.options
    assert got["psi_3d"][:, :, -1, 1].min() > 10 * o.psi_min
    assert got["nu_v_3d"][:, :, -1, 1].min() > 100 * o.visc_min
    assert got["tke_3d"][:, :, 0, 0].max() == o.k_min
    assert np.abs(got["uv_3d"][:, :, -1, 1, 0]).min() > 1e-4


@pytest.mark.slow
def test_kato_phillips_mixed_layer_depth():
    """The port's own 4 h run through ``iterate()``: the mixed-layer depth
    (the lowest point with tke > 1e-5) within 10% of
    1.05 u* sqrt(t / N0)."""
    ts, z_if = kato_phillips_port(4 * 3600.0)
    ts.iterate()
    assert ts.iteration == 240 and ts.i_export == 4
    tke = ts.fields.tke_3d.data.numpy()
    prof = np.concatenate([tke[0, 0, :, 0], tke[0, 0, -1:, 1]])
    zfine = np.linspace(z_if[0], z_if[-1], KP_LAYERS * 8)
    ix = np.interp(zfine, z_if, prof) > 1e-5
    assert ix.any(), "no turbulent layer developed"
    ml_depth = -zfine[ix].min()
    target = 1.05 * KP_US * np.sqrt(ts.simulation_time / KP_N0)
    assert abs(ml_depth - target) / target < 0.10, (ml_depth, target)
