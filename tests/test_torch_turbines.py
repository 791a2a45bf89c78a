"""Tidal turbine farms of ``thetis_tpu_torch`` against ``thetis_tpu``
(f64, CPU): the thrust and power models (constant and tabulated thrust,
with and without the rotor shear profile, the upwind correction and
support drag), the discrete farm's bump density, the SWE residual with
the turbine drag, one and five model steps of ``tests/test_turbines.py``'s
farm with the power callback, the carrying of farm options across
``interop``, and the reference tests' own checks through the port.

Tolerances: pointwise functions, densities and residuals 1e-12 of each
output's max; model steps 1e-9 of each field's max (a Krylov budget that
solves the step to roundoff) and the callback's powers 1e-9 relative.
Tests that set ``physical_constants["rho0"]`` set it in both packages and
restore both (``monkeypatch``).

``examples/tidalfarm``'s profit functional through the port's adjoint:
the example's set-up on a 12x4 channel over 2 steps, the gradient with
respect to the turbine density (``turbine_density_{i}`` through
``eq_sw._any_cell_q``) against ``jax.grad`` (1e-10 of the largest
entry), and the port's Taylor rate; the reference's solver is built as
the example builds it and carried to the port by ``interop``."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import thetis_tpu as J  # noqa: E402
import thetis_tpu.config as jconfig  # noqa: E402
import thetis_tpu.model.turbines as jturb  # noqa: E402
from thetis_tpu.model.turbines import (  # noqa: E402
    TidalTurbineFarmOptions as JFarm, TidalTurbineOptions as JTurbine)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
import thetis_tpu_torch.config as tconfig  # noqa: E402
import thetis_tpu_torch.model.turbines as tturb  # noqa: E402
from thetis_tpu_torch.adjoint import (  # noqa: E402
    Control, ReducedFunctional, taylor_test)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from test_torch_adjoint_swe import agree  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
TIGHT = dict(ksp_rtol=1e-12, ksp_max_it=480, gmres_restart=48)
MODEL_RTOL = 1e-9
#: the AR2000 curves of examples/discrete_turbines/tidal_array.py (cut
#: down to the part the flows here reach)
SPEEDS = [0., 0.75, 0.85, 0.95, 1., 3.05, 3.3, 3.55, 3.8, 4.05]
THRUSTS = [0.010531, 0.032281, 0.038951, 0.119951, 0.516484, 0.516484,
           0.387856, 0.302601, 0.242037, 0.197252]
POWERS = [0.0105, 0.032, 0.0385, 0.116, 0.437, 0.437, 0.345, 0.277, 0.226,
          0.187]


def tensor(v):
    return torch.as_tensor(np.asarray(v), dtype=F64)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture
def rho0_1026(monkeypatch):
    """The tidal-array example's density, in both packages, restored."""
    monkeypatch.setitem(jconfig.physical_constants, "rho0", 1026.0)
    monkeypatch.setitem(tconfig.physical_constants, "rho0", 1026.0)


def turbine_options(mod, thrust, shear, upwind, support, structure):
    fo = mod.DiscreteTidalTurbineFarmOptions()
    fo.turbine_type = thrust
    to = fo.turbine_options
    to.diameter = 20.0
    if thrust == "table":
        to.thrust_speeds = SPEEDS
        to.thrust_coefficients = THRUSTS
        to.power_coefficients = POWERS
    else:
        to.thrust_coefficient = 0.6
        to.power_coefficient = 0.55
    if support:
        to.C_support = 0.7
        to.A_support = 2.6 * 14.0
    if shear:
        to.apply_shear_profile = True
        to.structure_type = structure
        to.rel_hub_height = 14.0 if structure == "bottom-fixed" else 12.0
    fo.upwind_correction = upwind
    return fo


def turbine_inputs():
    """Seeded speeds 0-4.5 m/s (past cut-in and rated) and depths."""
    rng = np.random.default_rng(8)
    uv = rng.uniform(-3.2, 3.2, (30, 6, 2))
    uv[:3] = 0.0
    return uv, rng.uniform(30.0, 60.0, (30, 6))


CASES = [(thrust, shear, upwind, support, structure)
         for thrust in ("constant", "table")
         for shear, structure in ((False, "bottom-fixed"),
                                  (True, "bottom-fixed"), (True, "floating"))
         for upwind in (False, True) for support in (False, True)]


@pytest.mark.parametrize("thrust,shear,upwind,support,structure", CASES)
def test_turbine_models_match_reference(thrust, shear, upwind, support,
                                        structure, rho0_1026):
    """The drag coefficient the SWE reads and the power per turbine."""
    uv, H = turbine_inputs()
    out = {}
    for mod, arr in ((jturb, jnp.asarray), (tturb, tensor)):
        fo = turbine_options(mod, thrust, shear, upwind, support, structure)
        cls = (mod.ConstantThrustTurbine if thrust == "constant"
               else mod.TabulatedThrustTurbine)
        t = cls(fo.turbine_options, fo.upwind_correction)
        out[mod] = (t.friction_coefficient(arr(uv), arr(H)),
                    t.power(arr(uv), arr(H)))
    for want, got in zip(out[jturb], out[tturb]):
        if isinstance(want, float):
            assert got == want
        else:
            close(got, want, 1e-12)


@pytest.mark.parametrize("radius", [30.0, 60.0])
def test_turbine_density_matches_reference(radius):
    """The bump density of three turbines, each one turbine on the mesh's
    quadrature."""
    jm = J.RectangleMesh(20, 8, 1000.0, 400.0)
    tm = T.RectangleMesh(20, 8, 1000.0, 400.0, device="cpu")
    coords = [[300.0, 200.0], [510.0, 190.0], [700.0, 220.0]]
    want = jturb.turbine_density_from_coordinates(
        JAsm(jm, J.FunctionSpace(jm, "DG", 1)), coords, radius)
    asm = TAsm(tm, T.FunctionSpace(tm, "DG", 1))
    got = tturb.turbine_density_from_coordinates(asm, coords, radius)
    close(got, want, 1e-12)
    assert float(asm.integrate_cellq(got)) == pytest.approx(3.0, rel=1e-12)


def test_unresolved_turbine_raises():
    tm = T.RectangleMesh(20, 8, 1000.0, 400.0, device="cpu")
    asm = TAsm(tm, T.FunctionSpace(tm, "DG", 1))
    with pytest.raises(ValueError, match="not resolved"):
        tturb.turbine_density_from_coordinates(asm, [[312.3, 191.7]], 1.0)


# -- the model ----------------------------------------------------------------
def reference_farm(density=0.02, tight=True):
    """``test_turbines.py::farm_setup`` with a Krylov budget that solves
    the step to roundoff (its steppers rebuilt)."""
    from test_turbines import farm_setup

    s = farm_setup(density=density)
    if tight:
        s.options.swe_timestepper_options.solver_parameters = JNP(**TIGHT)
        s.create_timestepper()
    return s


@pytest.fixture(scope="module")
def farm_pair():
    ref = reference_farm(tight=False)
    tm = T.RectangleMesh(20, 8, 1000.0, 400.0, device="cpu")
    return ref, flowsolver2d_from_reference(ref, tm)


@pytest.mark.parametrize("term", ["TurbineDragTerm", "all"])
def test_swe_residual_with_turbine_drag(term, farm_pair):
    ref, port = farm_pair
    rng = np.random.default_rng(6)
    nc = port.mesh2d.nc
    st = dict(uv=rng.uniform(0.5, 3.0, (nc, 3, 2)),
              elev=0.1 * rng.standard_normal((nc, 3)))
    old = dict(uv=st["uv"] + 0.1 * rng.standard_normal((nc, 3, 2)),
               elev=st["elev"] + 0.01 * rng.standard_normal((nc, 3)))
    out = []
    for s, arr in ((ref, jnp.asarray), (port, tensor)):
        f = s._gather_swe_fields()
        r = s.eq_sw.residual(term, {k: arr(v) for k, v in st.items()},
                             {k: arr(v) for k, v in old.items()}, f, f,
                             s._gather_bnd("shallow_water"))
        out.append(r)
    for k in ("uv", "elev"):
        if term == "TurbineDragTerm" and k == "elev":
            assert float(np.abs(np.asarray(out[0][k])).max()) == 0.0
            continue
        close(out[1][k], out[0][k], 1e-12)


def test_farm_density_and_count(farm_pair):
    ref, port = farm_pair
    close(port.tidal_farms[0].turbine_density_q,
          ref.tidal_farms[0].turbine_density_q, 1e-12)
    assert port.tidal_farms[0].number_of_turbines() == pytest.approx(
        ref.tidal_farms[0].number_of_turbines(), rel=1e-12)


def test_farm_steps_and_power_match_reference():
    """One and five steps of the farm through ``iterate()`` with the
    power callback at every step: states and the callback's current and
    average powers."""
    ref = reference_farm()
    tm = T.RectangleMesh(20, 8, 1000.0, 400.0, device="cpu")
    port = flowsolver2d_from_reference(ref, tm)
    runs = []
    for s, cb_cls in ((ref, jturb.TurbineFunctionalCallback),
                      (port, tturb.TurbineFunctionalCallback)):
        cb = cb_cls(s, append_to_log=False)
        s.add_callback(cb, "timestep")
        s.options.simulation_export_time = 5 * s.options.timestep
        s.options.simulation_end_time = 5 * s.options.timestep
        states, powers = [], []
        for _ in s.create_iterator():
            states.append({k: np.array(v) for k, v in
                           s._get_state().items()})
            powers.append((list(cb.instantaneous_power),
                           list(cb.average_power)))
        runs.append((states, powers, cb))
    (ws, wp, wcb), (gs, gp, gcb) = runs
    assert len(ws) == len(gs) == 5
    for i in (0, 4):
        for k, v in ws[i].items():
            close(gs[i][k], v, MODEL_RTOL)
        np.testing.assert_allclose(gp[i], wp[i], rtol=MODEL_RTOL)
    assert gcb.time_period == pytest.approx(wcb.time_period, rel=1e-15)
    assert gcb.cost == pytest.approx(wcb.cost, rel=1e-12)
    assert gcb.average_power[0] > 0.0


def test_interop_carries_a_discrete_farm(rho0_1026):
    """The tidal-array example's two discrete farms (table and constant
    thrust, shear, upwind correction, support drag) cross to the port as
    port options objects, one for one, with their values; the densities
    built from them agree."""
    jm = J.RectangleMesh(100, 30, 2000.0, 600.0)
    s = J.solver2d.FlowSolver2d(jm, J.Function(
        J.FunctionSpace(jm, "CG", 1)).assign(50.0))
    o = s.options
    o.timestep = 50.0
    o.simulation_export_time = 50.0
    o.simulation_end_time = 50.0
    o.no_exports = True
    f1 = turbine_options(jturb, "table", True, True, True, "bottom-fixed")
    f1.turbine_coordinates = [[1000.0, 260.0], [1000.0, 340.0]]
    f2 = turbine_options(jturb, "constant", True, False, False,
                         "bottom-fixed")
    f2.turbine_coordinates = [[900.0, 300.0]]
    o.discrete_tidal_turbine_farms["everywhere"] = [f1, f2]
    s.bnd_functions["shallow_water"] = {1: {"un": J.Constant(-2.5)},
                                        2: {"elev": J.Constant(0.0)}}
    s.assign_initial_conditions()
    port = flowsolver2d_from_reference(
        s, T.RectangleMesh(100, 30, 2000.0, 600.0, device="cpu"))
    pf = port.options.discrete_tidal_turbine_farms["everywhere"]
    assert [type(f) for f in pf] == [tturb.DiscreteTidalTurbineFarmOptions] * 2
    for jf, tf in zip((f1, f2), pf):
        assert tf.turbine_coordinates == jf.turbine_coordinates
        assert tf.upwind_correction == jf.upwind_correction
        assert vars(tf.turbine_options) == vars(jf.turbine_options)
    assert [f.number_of_turbines() for f in port.tidal_farms] == \
        pytest.approx([f.number_of_turbines() for f in s.tidal_farms],
                      rel=1e-12)
    for jf, tf in zip(s.tidal_farms, port.tidal_farms):
        close(tf.turbine_density_q, jf.turbine_density_q, 1e-12)


# -- the reference tests through the port --------------------------------------
def port_farm(density=0.01):
    """``test_turbines.py::farm_setup`` through the port's facade."""
    lx, ly = 1000.0, 400.0
    mesh2d = T.RectangleMesh(20, 8, lx, ly, device="cpu")
    P1 = T.FunctionSpace(mesh2d, "CG", 1)
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(P1).assign(40.0))
    o = so.options
    o.timestep = 10.0
    o.simulation_export_time = 100.0
    o.simulation_end_time = 100.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = T.Constant(2.0)
    o.quadratic_drag_coefficient = T.Constant(0.0025)
    farm = tturb.TidalTurbineFarmOptions()
    farm.turbine_options = tturb.TidalTurbineOptions(diameter=18.0,
                                                     thrust_coefficient=0.8)
    x, y = T.SpatialCoordinate(mesh2d)
    farm.turbine_density = T.Function(P1).interpolate(torch.where(
        (torch.abs(x - lx / 2) < 150.0) & (torch.abs(y - ly / 2) < 100.0),
        density, 0.0))
    o.tidal_turbine_farms = {"everywhere": [farm]}
    so.bnd_functions["shallow_water"] = {1: {"un": T.Constant(-1.5)},
                                         2: {"elev": T.Constant(0.0)}}
    so.assign_initial_conditions(uv=torch.tensor([1.5, 0.0], dtype=F64),
                                 elev=0.0)
    return so


def test_port_discrete_farm_density_integral():
    mesh2d = T.RectangleMesh(40, 16, 1000.0, 400.0, device="cpu")
    asm = TAsm(mesh2d, T.FunctionSpace(mesh2d, "DG", 1))
    density = tturb.turbine_density_from_coordinates(
        asm, [[300.0, 200.0], [500.0, 200.0], [700.0, 200.0]], radius=9.0)
    assert float(asm.integrate_cellq(density)) == pytest.approx(3.0,
                                                                rel=0.25)


def test_port_rotor_shear_averaging():
    depth = torch.full((5, 4), 40.0, dtype=F64)
    uv = torch.stack([torch.full((5, 4), 2.0, dtype=F64),
                      torch.zeros((5, 4), dtype=F64)], dim=-1)

    def turbine(hub, structure="bottom-fixed"):
        o = tturb.TidalTurbineOptions(diameter=10.0, thrust_coefficient=0.8)
        o.apply_shear_profile = True
        o.rel_hub_height = hub
        o.structure_type = structure
        return tturb.ConstantThrustTurbine(o)

    u_eff = turbine(0.4 * 40.0).rotor_averaged_velocity(uv, depth)
    assert tuple(u_eff.shape) == (5, 4)
    assert abs(float(u_eff[0, 0]) - 2.0) < 0.05
    t_low = turbine(8.0)
    u_low = float(t_low.rotor_averaged_velocity(uv, depth)[0, 0])
    assert u_low < 2.0
    u_float = float(turbine(6.0, "floating").rotor_averaged_velocity(
        uv, depth)[0, 0])
    assert u_float > u_low
    p = t_low.power(uv, depth)
    cd = t_low.friction_coefficient(uv, depth)
    # a constant-thrust coefficient without the upwind correction is a
    # number, as in the reference
    assert bool(torch.isfinite(p).all()) and np.isfinite(float(cd))
    p0 = turbine(0.4 * 40.0).power(uv, depth)
    assert float(p[0, 0]) < float(p0[0, 0])


def test_port_minimum_distance_constraints():
    pos = [[0.0, 0.0], [100.0, 0.0], [0.0, 40.0]]
    mdc = tturb.MinimumDistanceConstraints(pos, minimum_distance=50.0)
    assert mdc.length() == 3
    m = np.asarray([x for xy in pos for x in xy])
    f = mdc.function(m)
    assert f[0] > 0 and f[1] < 0
    Jm = mdc.jacobian(m)
    eps = 1e-6
    for k in range(len(m)):
        mp = m.copy()
        mp[k] += eps
        mm = m.copy()
        mm[k] -= eps
        fd = (mdc.function(mp) - mdc.function(mm)) / (2 * eps)
        assert np.allclose(Jm[:, k], fd, atol=1e-4)
    assert mdc.scipy_constraint()["type"] == "ineq"


def test_port_load_turbine_file(tmp_path):
    cfg = {
        "name": "test_turbine", "turbine_thrust_def": "table",
        "diameter": 20.0,
        "curves": {"speeds": [0.0, 1.0, 2.0, 3.0],
                   "thrust": [0.0, 0.6, 0.8, 0.7],
                   "power": [0.0, 0.3, 0.45, 0.4]},
        "support_structure": {"type": "monopile", "rel_hub_height": 0.5,
                              "C_support": 0.7, "A_support": 25.0},
        "upwind_correction": False,
    }
    jpath = tmp_path / "turbine.json"
    jpath.write_text(json.dumps(cfg))
    opts = tturb.load_turbine(str(jpath))
    assert isinstance(opts, tturb.DiscreteTidalTurbineFarmOptions)
    assert opts.turbine_type == "table"
    assert opts.turbine_options.diameter == 20.0
    assert opts.turbine_options.thrust_speeds == [0.0, 1.0, 2.0, 3.0]
    assert opts.turbine_options.structure_type == "monopile"
    assert opts.turbine_options.C_support == 0.7
    assert opts.upwind_correction is False
    yaml = pytest.importorskip("yaml")
    cfg2 = dict(cfg, turbine_thrust_def="constant", thrust_coefficient=0.75,
                power_coefficient=0.4)
    del cfg2["curves"]
    ypath = tmp_path / "turbine.yml"
    ypath.write_text(yaml.safe_dump(cfg2))
    opts2 = tturb.load_turbine(str(ypath), discrete=False)
    assert isinstance(opts2, tturb.TidalTurbineFarmOptions)
    assert opts2.turbine_options.thrust_coefficient == 0.75
    assert opts2.turbine_type == "constant"


@pytest.mark.slow
def test_port_farm_drag_creates_head_difference():
    heads = []
    for d in (0.0, 0.05):
        so = port_farm(density=d)
        so.iterate()
        e = so.fields.elev_2d.data
        x = so.function_spaces.H_2d.dof_coords()[..., 0]
        up = float(torch.where(x < 200, e, 0.0).mean())
        dn = float(torch.where(x > 800, e, 0.0).mean())
        heads.append(up - dn)
    assert heads[1] > 10 * heads[0] > 0


@pytest.mark.slow
def test_port_power_callback():
    so = port_farm(density=0.02)
    cb = tturb.TurbineFunctionalCallback(so, append_to_log=False)
    so.add_callback(cb, "timestep")
    so.iterate()
    assert cb.average_power[0] > 0.0
    assert cb.time_period == pytest.approx(100.0)
    nt = so.tidal_farms[0].number_of_turbines()
    assert 0.0 < nt < 0.02 * 300 * 200
    assert nt == pytest.approx(float(so.asm.integrate_cellq(
        so.tidal_farms[0].turbine_density_q)), rel=1e-12)


# -- the farm's profit gradient (examples/tidalfarm) -------------------------
def farm(nx=12, ny=4, lx=2000.0, ly=600.0):
    """``examples/tidalfarm``'s set-up on a coarser channel (the
    reference), and the port's copy of it."""
    jm = J.RectangleMesh(nx, ny, lx, ly)
    p1 = J.FunctionSpace(jm, "CG", 1)
    so = J.solver2d.FlowSolver2d(jm, J.Function(p1).assign(40.0))
    o = so.options
    o.timestep = 10.0
    o.simulation_export_time = 200.0
    o.simulation_end_time = 200.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = J.Constant(2.0)
    o.quadratic_drag_coefficient = J.Constant(0.0025)
    f = JFarm()
    f.turbine_options = JTurbine(diameter=18.0, thrust_coefficient=0.8)
    x, y = J.SpatialCoordinate(jm)
    mask = (jnp.abs(x - lx / 2) < 300.0) & (jnp.abs(y - ly / 2) < 200.0)
    f.turbine_density = J.Function(p1).interpolate(
        jnp.where(mask, 0.003, 0.0))
    f.break_even_wattage = 200.0
    o.tidal_turbine_farms = {"everywhere": [f]}
    so.bnd_functions["shallow_water"] = {1: {"un": J.Constant(-2.0)},
                                         2: {"elev": J.Constant(0.0)}}
    so.assign_initial_conditions(uv=jnp.asarray([2.0, 0.0]), elev=0.0)
    so.initialize()
    port = flowsolver2d_from_reference(so, tgen.RectangleMesh(
        nx, ny, lx, ly, device="cpu", dtype=F64))
    return so, port


def profit_forward(s, n_steps):
    """The example's average-profit step functional, either package."""
    asm, farm_obj, dt = s.asm, s.tidal_farms[0], s.dt
    wattage = 200.0

    def profit_step(state, fields, t):
        uv_q = asm.cell_values(state["uv"])
        eta_q = asm.cell_values(state["elev"])
        H_q = s.depth.total_depth(s.eq_sw.bathy_q, eta_q)
        density_q = fields["turbine_density_0"]
        power = asm.integrate_cellq(
            farm_obj.turbine.power(uv_q, H_q) * density_q)
        cost = wattage * asm.integrate_cellq(density_q)
        return (power - cost) / (n_steps * dt)

    return s.differentiable_forward(["turbine_density_0"],
                                    step_functional=profit_step,
                                    n_steps=n_steps)


def test_farm_density_gradient():
    so, port = farm()
    assert len(port.tidal_farms) == 1
    d0 = np.asarray(so.options.tidal_turbine_farms["everywhere"][0]
                    .turbine_density.data)
    jv, jg = jax.jit(jax.value_and_grad(profit_forward(so, 2)))(
        jnp.asarray(d0))
    fp = profit_forward(port, 2)
    dt_ = torch.tensor(d0, requires_grad=True)
    tv = fp(dt_)
    (tg,) = torch.autograd.grad(tv, dt_)
    agree((float(tv.detach()), [tg.numpy()]), (float(jv), [np.asarray(jg)]))
    rf = ReducedFunctional(fp, Control(torch.tensor(d0)), scale=-1e-5)
    rng = np.random.default_rng(3)
    assert taylor_test(rf, d0, 0.001 * rng.random(d0.shape), h0=0.2) > 1.9
