"""The reference's turbulence, mode-split, 3D-solver and Runge-Kutta test
files through ``thetis_tpu_torch`` on the CPU in f64, each test under
the reference test's own name and bounds:

* ``tests/test_turbulence.py``: the stability functions' published
  constants and limiters, a GLS column spun up by shear, stratification
  damping the mixing, Pacanowski-Philander, every stability family;
* ``tests/test_modesplit_dt.py``: the 2D subcycling ratio, the '2d' time
  step, and the subcycled explicit 2D mode against the implicit one;
* ``tests/test_solver3d.py`` (its ``test_3d_callbacks`` is in
  ``test_torch_io_callbacks.py``): the 3D run against the 2D model,
  uniform tracers kept uniform, the lock exchange, the HCC metric, the
  SSPRK22 and LeapFrogAM3 ALE integrators, the weak density and the
  velocity magnitude, the time-step control and the 3D limiter;
* ``tests/test_convergence_ode.py::test_butcher_to_shuosher``.

The reference marks several of these ``slow``; on the port each runs in
seconds on the CPU, so all are tier-1."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.eos import (  # noqa: E402
    LinearEquationOfState)
from thetis_tpu_torch.equations.limiter import (  # noqa: E402
    VertexBasedP1DGLimiter3D)
from thetis_tpu_torch.equations.stability_functions import (  # noqa: E402
    STABILITY_FUNCTIONS, StabilityFunctionCanutoA, StabilityFunctionCanutoB,
    StabilityFunctionCheng)
from thetis_tpu_torch.equations.turbulence import (  # noqa: E402
    GenericLengthScaleModel, PacanowskiPhilanderModel)
from thetis_tpu_torch.equations.utility3d import (  # noqa: E402
    DensitySolver, DensitySolverWeak, Mesh3DConsistencyCalculator,
    VelocityMagnitudeSolver)
from thetis_tpu_torch.fem.assembly3d import Assembler3D  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh  # noqa: E402
from thetis_tpu_torch.model.flowsolver3d import FlowSolver  # noqa: E402
from thetis_tpu_torch.timeintegration.rungekutta import (  # noqa: E402
    SCHEMES, butcher_to_shuosher_form)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def rect(*args):
    return T.RectangleMesh(*args, device="cpu", dtype=F64)


def full(shape, value):
    return torch.full(shape, value, dtype=F64)


def tensor(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# -- tests/test_turbulence.py -----------------------------------------------
def test_stability_function_parameters():
    """Canuto A cmu0 ~ 0.527, Canuto B ~ 0.554, Cheng ~ 0.520; k-epsilon
    c3_minus in (-0.9, -0.4); S_m alpha_M = 1 at the neutral limit."""
    sfa = StabilityFunctionCanutoA()
    assert sfa.compute_cmu0() == pytest.approx(0.527, abs=0.01)
    assert StabilityFunctionCanutoB().compute_cmu0() == pytest.approx(
        0.554, abs=0.01)
    assert StabilityFunctionCheng().compute_cmu0() == pytest.approx(
        0.520, abs=0.01)
    assert -0.9 < sfa.compute_c3_minus(1.44, 1.92, 0.25) < -0.4
    a_shear = sfa.compute_alpha_shear_steady(1e-8)
    s_m, _ = sfa.eval_funcs(0.0, a_shear)
    assert float(s_m * a_shear) == pytest.approx(1.0, rel=1e-6)


def test_stability_function_limiters():
    s_m, s_h = StabilityFunctionCanutoA().evaluate(
        tensor([1e-4, 1e-2]), tensor([-1e-2, 1e-4]), tensor([1e-3, 1e-3]),
        tensor([1e-6, 1e-6]))
    assert bool(torch.isfinite(s_m).all()) and bool(torch.isfinite(s_h).all())
    assert bool((s_m > 0).all()) and bool((s_h > 0).all())


@pytest.fixture(scope="module")
def column():
    m = rect(2, 2, 100.0, 100.0)
    ext = ExtrudedMesh(m, n_layers=20)
    a3 = Assembler3D(m, T.DGAssembler(m, T.FunctionSpace(m, "DG", 1)), ext)
    geom = a3.layer_geometry(ext.z_interfaces(full((m.nc, 3), 50.0),
                                              full((m.nc, 3), 0.0)))
    return m, ext, a3, geom


def test_gls_column_spinup(column):
    """Under a constant shear TKE grows from its seed, the viscosity
    develops, all stays positive and finite; under stratification the
    Galperin limit caps the length scale."""
    m, ext, a3, geom = column
    model = GenericLengthScaleModel(a3)
    o = model.options
    shape = (m.nc, 3, ext.nz, 2)
    k = full(shape, o.k_min)
    psi = model.psi_from_k_eps(k, o.cmu0 ** 3 * o.k_min ** 1.5 / 0.3)
    m2, n2 = full(shape, 1e-4), full(shape, 0.0)
    nu = full(shape, o.visc_min)
    for _ in range(120):
        nu, mu, _, _ = model.eddy_coefficients(k, psi, m2, n2)
        k, psi = model.step_columns(k, psi, m2, n2, nu, mu,
                                    geom["Delta_nodes"], 30.0)
    k_np, nu_np = k.numpy(), nu.numpy()
    assert np.isfinite(k_np).all() and np.isfinite(psi.numpy()).all()
    assert (k_np > 0).all() and (nu_np > 0).all()
    assert k_np.max() > 100 * o.k_min, "TKE did not grow under shear"
    assert nu_np.max() > 1e-4, "eddy viscosity did not develop"
    _, _, _, l_s = model.eddy_coefficients(k, psi, m2, full(shape, 1e-4))
    lmax = o.galperin_clim * np.sqrt(2 * k_np.max() / 1e-4)
    assert float(l_s.max()) <= lmax * 1.01


def test_stratification_suppresses_mixing(column):
    m, ext, a3, geom = column
    model = GenericLengthScaleModel(a3)
    shape = (m.nc, 3, ext.nz, 2)
    k = full(shape, 1e-4)
    psi = model.psi_from_k_eps(k, full(shape, 1e-7))
    m2 = full(shape, 1e-4)
    _, mu_neutral, _, _ = model.eddy_coefficients(k, psi, m2,
                                                  full(shape, 0.0))
    _, mu_strat, _, _ = model.eddy_coefficients(k, psi, m2,
                                                full(shape, 1e-4))
    assert float(mu_strat.mean()) < float(mu_neutral.mean())


def test_pacanowski_philander():
    pp = PacanowskiPhilanderModel()
    nu0, mu0 = pp.eddy_coefficients(tensor(1e-4), tensor(0.0))
    nu1, mu1 = pp.eddy_coefficients(tensor(1e-4), tensor(1e-4))
    assert float(nu0) == pytest.approx(5e-2, rel=1e-3)
    assert float(nu1) < float(nu0) and float(mu1) < float(mu0)


def test_stability_function_variants():
    """Every family's cmu0 within 2e-3 of Umlauf & Burchard (2005) Table
    4, c3_minus in (-1.5, 0), finite positive limited evaluations."""
    published_cmu0 = {
        "Canuto A": 0.5270, "Canuto B": 0.5540, "Cheng": 0.5270,
        "Canuto A GOTM": 0.5265, "Canuto B GOTM": 0.5540,
        "Kantha-Clayson": 0.5549, "Cheng GOTM": 0.5270,
    }
    assert set(STABILITY_FUNCTIONS) == set(published_cmu0)
    for name, cls in STABILITY_FUNCTIONS.items():
        sf = cls()
        assert abs(float(sf.compute_cmu0()) - published_cmu0[name]) < 2e-3
        assert -1.5 < float(sf.compute_c3_minus(1.44, 1.92, 0.25)) < 0.0
        sm, sh = sf.evaluate(tensor(1e-4), tensor(-1e-5), tensor(1e-5),
                             tensor(1e-6))
        assert np.isfinite(float(sm)) and np.isfinite(float(sh))
        assert float(sm) > 0 and float(sh) > 0, name


# -- tests/test_modesplit_dt.py ---------------------------------------------
def split_solver(dt_mode, lx=20e3, depth=20.0, **opts):
    """``test_modesplit_dt.py::_solver`` through the port."""
    mesh2d = rect(12, 2, lx, 4e3)
    p1 = T.FunctionSpace(mesh2d, "CG", 1)
    so = FlowSolver(mesh2d, T.Function(p1).assign(depth), 4)
    o = so.options
    o.timestep = 60.0
    o.timestep_2d = 10.0
    o.dt_mode = dt_mode
    o.simulation_export_time = 600.0
    o.simulation_end_time = 600.0
    o.no_exports = True
    o.solve_salinity = False
    o.solve_temperature = False
    o.use_baroclinic_formulation = False
    o.use_implicit_vertical_diffusion = False
    o.use_bottom_friction = False
    o.horizontal_viscosity = 1.0
    for k, v in opts.items():
        setattr(o, k, v)
    so.assign_initial_conditions(elev=T.Function(p1).interpolate(
        lambda x, y: 0.3 * torch.exp(-(((x - lx / 2) / 3e3) ** 2))))
    return so


def test_modesplit_ratio():
    so = split_solver("split")
    assert so.M_modesplit == 6
    np.testing.assert_allclose(so.dt_2d * so.M_modesplit, so.dt, rtol=1e-12)
    so3 = split_solver("3d")
    assert so3.M_modesplit == 1 and so3.dt_2d == so3.dt


def test_dt_mode_2d():
    so = split_solver("2d", use_automatic_timestep=True,
                      horizontal_velocity_scale=1.0)
    max_dt_3d = min(so.compute_dt_h_advection(1.0),
                    so.compute_dt_v_advection(1e-4),
                    so.compute_dt_diffusion(
                        so.options.horizontal_viscosity_scale))
    assert so.dt <= max_dt_3d * 1.0001
    assert so.M_modesplit == 1 and so.dt_2d == so.dt


def test_split_matches_implicit_barotropic():
    so_i, so_s = split_solver("3d"), split_solver("split")
    so_i.iterate()
    so_s.iterate()
    e_i = so_i.fields.elev_2d.data.numpy()
    e_s = so_s.fields.elev_2d.data.numpy()
    assert np.abs(e_s - e_i).max() < 0.1 * np.abs(e_i).max()
    assert np.isfinite(so_s.fields.uv_3d.data.numpy()).all()


# -- tests/test_solver3d.py -------------------------------------------------
def make_solver3d(nx=12, nz=6, lx=20e3, depth=20.0, **opts):
    """``test_solver3d.py::make_solver3d`` through the port."""
    mesh2d = rect(nx, 2, lx, 4e3)
    so = FlowSolver(mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1))
                    .assign(depth), nz)
    o = so.options
    o.timestep = 30.0
    o.simulation_export_time = 300.0
    o.simulation_end_time = 300.0
    o.no_exports = True
    o.horizontal_viscosity = 1.0
    o.horizontal_diffusivity = 1.0
    for k, v in opts.items():
        setattr(o, k, v)
    return so


def bump(so, amp):
    return T.Function(T.FunctionSpace(so.mesh2d, "CG", 1)).interpolate(
        lambda x, y: amp * torch.exp(-(((x - 10e3) / 3e3) ** 2)))


def test_barotropic_consistency():
    """Uniform density: the 3D elevation follows the 2D model's to 0.15
    of its scale, the deviation velocity under 0.25 of the barotropic."""
    so3 = make_solver3d(use_baroclinic_formulation=False,
                        use_implicit_vertical_diffusion=False,
                        use_bottom_friction=False)
    elev0 = T.Function(T.FunctionSpace(so3.mesh2d, "CG", 1)).interpolate(
        lambda x, y: 0.5 * torch.exp(-(((x - 10e3) / 3e3) ** 2)))
    so3.assign_initial_conditions(elev=elev0)
    so3.iterate()
    so2 = T.solver2d.FlowSolver2d(
        so3.mesh2d, T.Function(T.FunctionSpace(so3.mesh2d, "CG", 1))
        .assign(20.0))
    o2 = so2.options
    o2.timestep = 30.0
    o2.simulation_export_time = 300.0
    o2.simulation_end_time = 300.0
    o2.no_exports = True
    o2.swe_timestepper_type = "CrankNicolson"
    o2.swe_timestepper_options.use_semi_implicit_linearization = True
    o2.horizontal_viscosity = 1.0
    so2.assign_initial_conditions(elev=elev0)
    so2.iterate()
    e3 = so3.fields.elev_2d.data.numpy()
    e2 = so2.fields.elev_2d.data.numpy()
    assert np.abs(e3 - e2).max() < 0.15 * np.abs(e2).max()
    u2 = np.abs(so3.fields.uv_2d.data.numpy()).max()
    assert np.abs(so3.fields.uv_3d.data.numpy()).max() < 0.25 * u2 + 1e-8


def uniform_tracers_stay(so):
    so.assign_initial_conditions(elev=bump(so, 0.3), salt=35.0, temp=10.0)
    so.iterate()
    assert np.abs(so.fields.salt_3d.data.numpy() - 35.0).max() < 1e-9
    assert np.abs(so.fields.temp_3d.data.numpy() - 10.0).max() < 1e-9
    assert np.isfinite(so.fields.uv_3d.data.numpy()).all()


def lock_exchange(so, t_end):
    """The front at x = 4 km, cold on the left; returns (uv_3d, temp,
    front mask)."""
    so.options.timestep = 20.0
    so.options.simulation_export_time = 200.0
    so.options.simulation_end_time = t_end
    V = T.FunctionSpace(so.mesh2d, "DG", 1)
    t2d = T.Function(V).interpolate(
        lambda x, y: 5.0 * torch.tanh((x - 4e3) / 400.0))
    so.assign_initial_conditions(temp=t2d.data, salt=35.0)
    so.iterate()
    uv3 = so.fields.uv_3d.data.numpy()
    temp = so.fields.temp_3d.data.numpy()
    assert np.isfinite(uv3).all() and np.isfinite(temp).all()
    front = np.abs(V.dof_coords()[..., 0].numpy() - 4e3) < 2e3
    return uv3, temp, front


def test_tracer_consistency_coupled():
    uniform_tracers_stay(make_solver3d())


def test_lock_exchange():
    """Bottom flow toward the warm side, surface flow back, temperature
    bounded, w developed."""
    so = make_solver3d(nx=16, nz=8, lx=8e3)
    uv3, temp, front = lock_exchange(so, 600.0)
    assert uv3[:, :, 0, 0, 0][front].mean() > 0
    assert uv3[:, :, -1, 1, 0][front].mean() < 0
    assert temp.min() > -7.0 and temp.max() < 7.0
    assert np.abs(so.fields.w_3d.data.numpy()).max() > 1e-7


def test_hcc_metric():
    so = make_solver3d()
    so.assign_initial_conditions()
    assert float(Mesh3DConsistencyCalculator(so).solve().abs().max()) < 1e-10
    mesh2d = rect(12, 2, 20e3, 4e3)
    bath = T.Function(T.FunctionSpace(mesh2d, "CG", 1)).interpolate(
        lambda x, y: 10.0 + 8.0 * x / 20e3)
    so2 = FlowSolver(mesh2d, bath, 6)
    so2.options.timestep = 30.0
    so2.options.simulation_export_time = 300.0
    so2.options.simulation_end_time = 300.0
    so2.options.no_exports = True
    so2.assign_initial_conditions()
    hcc2 = Mesh3DConsistencyCalculator(so2).solve()
    assert float(hcc2.max()) > 0.01 and bool(torch.isfinite(hcc2).all())


@pytest.mark.parametrize("stepper", ["SSPRK22", "LeapFrogAM3"])
def test_ale_integrator_consistency_and_lock_exchange(stepper):
    """``test_solver3d.py::test_ssprk22_ale_two_stage`` and
    ``test_leapfrog_am3``: uniform tracers kept to 1e-9, and the lock
    exchange's bottom flow toward the warm side."""
    uniform_tracers_stay(make_solver3d(timestepper_type=stepper))
    so = make_solver3d(nx=16, nz=8, lx=8e3, timestepper_type=stepper)
    uv3, _, front = lock_exchange(so, 400.0)
    assert uv3[:, :, 0, 0, 0][front].mean() > 0


def test_density_weak_and_velocity_magnitude():
    so = make_solver3d(nx=6, nz=3)
    so.assign_initial_conditions(salt=34.0, temp=12.0)
    so.initialize()
    geom = so.asm3d.layer_geometry(
        so.extruded.z_interfaces(so.bathy_cell, so.fields.elev_2d.data))
    eos = LinearEquationOfState()
    salt, temp = so.fields.salt_3d.data, so.fields.temp_3d.data
    rho_pt = DensitySolver(eos).solve(salt, temp)
    rho_wk = DensitySolverWeak(so.asm3d, eos).solve(salt, temp, geom)
    assert np.allclose(rho_pt.numpy(), rho_wk.numpy(), atol=1e-8)
    vms = VelocityMagnitudeSolver(so.asm3d, min_val=1e-3)
    uv = full(so.shape3 + (2,), 0.0)
    assert float((vms.solve(geom, uv=uv, w=None) - 1e-3).abs().max()) < 1e-12
    uv3 = torch.tensor([3.0, 4.0], dtype=F64).expand(so.shape3 + (2,))
    assert float((vms.solve(geom, uv=uv3) - 5.0).abs().max()) < 1e-8


def test_3d_time_step_control():
    so = make_solver3d(nx=12, nz=6)
    o = so.options
    o.use_automatic_timestep = True
    o.horizontal_velocity_scale = 1.0
    o.vertical_velocity_scale = 1e-3
    o.horizontal_viscosity_scale = 1.0
    so.create_fields()
    so.initialize()
    assert so.compute_dt_2d(1.0) < so.compute_dt_h_advection(1.0)
    assert so.compute_dt_v_advection(1e-3) > 0
    assert so.compute_dt_diffusion(1.0) > 0
    n = o.simulation_export_time / so.dt
    assert abs(n - round(n)) < 1e-9 and so.dt > 0


def test_limiter3d():
    """Uniform and linear-in-z fields pass; a spike is clipped with the
    element means kept."""
    mesh2d = rect(6, 3, 6e3, 3e3)
    nz = 5
    lim = VertexBasedP1DGLimiter3D(mesh2d, nz)
    np.testing.assert_allclose(lim.apply(full((mesh2d.nc, 3, nz, 2), 3.3))
                               .numpy(), 3.3)
    z = np.linspace(0.0, 1.0, nz + 1)
    u2 = tensor(np.broadcast_to(np.stack([z[:-1], z[1:]], axis=-1)[None, None],
                                (mesh2d.nc, 3, nz, 2)))
    np.testing.assert_allclose(lim.apply(u2).numpy(), u2.numpy(), atol=1e-12)
    u3 = np.zeros((mesh2d.nc, 3, nz, 2))
    u3[4, 1, 2, 1] = 6.0
    u3[4, 0, 2, 0] = -6.0
    out3 = lim.apply(tensor(u3)).numpy()
    np.testing.assert_allclose(out3.mean(axis=(1, 3)), u3.mean(axis=(1, 3)),
                               atol=1e-12)
    assert out3.max() < u3.max() - 1.0, "overshoot not limited"


# -- tests/test_convergence_ode.py::test_butcher_to_shuosher ----------------
def test_butcher_to_shuosher():
    tb = SCHEMES["SSPRK33"]()
    alpha, beta = butcher_to_shuosher_form(tb.a, tb.b)
    np.testing.assert_allclose(alpha, [
        [1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.75, 0.25, 0.0, 0.0],
        [1.0 / 3.0, 0.0, 2.0 / 3.0, 0.0]], atol=1e-12)
    np.testing.assert_allclose(beta, [
        [0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.0, 0.25, 0.0, 0.0],
        [0.0, 0.0, 2.0 / 3.0, 0.0]], atol=1e-12)
    tb2 = SCHEMES["DIRK33"]()
    a2, b2 = butcher_to_shuosher_form(tb2.a, tb2.b)
    np.testing.assert_allclose(np.asarray(a2).sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(b2)[:, 1:],
        np.vstack((tb2.a, tb2.b)) - np.asarray(a2)[:, 1:] @ np.asarray(tb2.a),
        atol=1e-12)
