"""The reference's inversion and adjoint-checkpointing tests through
``thetis_tpu_torch`` on the CPU in f64, each under the reference test's
own name and bounds:

* ``tests/test_inversion.py``: station elevations from a 0.05 Manning
  channel (16 x 4, 20 CN steps), then the friction inverted from a wrong
  guess with the port's ``inversion_tools`` (the cost falls tenfold, the
  control moves halfway to the truth; ``slow``, as in the reference: ~70
  s of L-BFGS-B on the CPU) and the gradient's Taylor rate above 1.9
  (~10 s, tier-1);
* ``tests/test_checkpointing.py``: ``differentiable_forward`` with the
  sqrt-N checkpointing gives the plain gradient (tier-1, seconds), and a
  1000-step gradient under it passes the Taylor test (``slow``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.adjoint import (  # noqa: E402
    Control, ReducedFunctional, taylor_test)
from thetis_tpu_torch.adjoint.inversion_tools import (  # noqa: E402
    GradientRegularizationCalculator, InversionManager,
    StationObservationManager)
from thetis_tpu_torch.utils.constant import Constant  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
STATIONS = dict(names=["stationA", "stationB", "stationC"],
                x=[1000.0, 2500.0, 4000.0], y=[500.0, 500.0, 500.0])
N_STEPS = 20
TRUE_MANNING = 0.05


def make_solver(manning_value):
    """``test_inversion.py::make_solver`` through the port."""
    mesh2d = T.RectangleMesh(16, 4, 5e3, 1e3, device="cpu", dtype=F64)
    p1 = T.FunctionSpace(mesh2d, "CG", 1)
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(p1).assign(20.0))
    o = so.options
    o.timestep = 20.0
    o.simulation_export_time = 400.0
    o.simulation_end_time = 400.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.manning_drag_coefficient = T.Function(
        p1, data=torch.full((mesh2d.nv,), float(manning_value), dtype=F64))
    so.bnd_functions["shallow_water"] = {1: {"un": Constant(-0.5)},
                                         2: {"elev": Constant(0.0)}}
    so.assign_initial_conditions(uv=torch.tensor([0.5, 0.0], dtype=F64),
                                 elev=0.0)
    return so


@pytest.fixture(scope="module")
def observations():
    """The truth's station elevations after each of its steps."""
    so = make_solver(TRUE_MANNING)
    sta = StationObservationManager(so)
    sta._xy = list(zip(STATIONS["x"], STATIONS["y"]))
    sta.construct_evaluator()
    state = so._get_state()
    fields = so._gather_swe_fields()
    bnd = so._gather_bnd("shallow_water")
    samples = {n: [] for n in STATIONS["names"]}
    times = []
    for i in range(N_STEPS):
        state = so._advance(0.0, state, fields, {}, bnd, {})
        vals = np.asarray(sta.sample(state))
        times.append((i + 1) * so.dt)
        for n, v in zip(STATIONS["names"], vals):
            samples[n].append(float(v))
    return times, samples


def build_inversion(observations, manning0):
    times, samples = observations
    so = make_solver(manning0)
    sta = StationObservationManager(so)
    sta.register_observation_data(
        STATIONS["names"], "elev", [times] * 3,
        [samples[n] for n in STATIONS["names"]], STATIONS["x"],
        STATIONS["y"])
    sta.construct_evaluator()
    im = InversionManager(sta, real_cost_function_scaling=1.0)
    im.add_control("manning_drag_coefficient",
                   so.options.manning_drag_coefficient,
                   regularization=GradientRegularizationCalculator(
                       so.asm, gamma=1e-4))
    return so, im


@pytest.mark.slow
def test_inversion_recovers_manning(observations, tmp_path):
    so, im = build_inversion(observations, manning0=0.02)
    rf = im.get_reduced_functional(N_STEPS)
    im.output_dir = str(tmp_path)
    j0 = rf()
    im.consistency_test()
    result = im.minimize(maxiter=12, ftol=1e-12, gtol=1e-12)
    j1 = rf([result])
    print(f"port J: {j0:.4e} -> {j1:.4e}")
    assert j1 < 0.1 * j0, "cost did not decrease sufficiently"
    recovered = float(np.mean(np.asarray(result)))
    assert abs(recovered - TRUE_MANNING) < abs(0.02 - TRUE_MANNING) * 0.5


def test_inversion_taylor(observations):
    so, im = build_inversion(observations, manning0=0.03)
    im.get_reduced_functional(N_STEPS)
    assert im.taylor_test(h0=5e-2) > 1.9


# -- tests/test_checkpointing.py --------------------------------------------
def checkpoint_solver(n_steps, dt=3.0):
    """``test_checkpointing.py::_make_solver`` through the port."""
    mesh2d = T.RectangleMesh(8, 4, 1e3, 400.0, device="cpu", dtype=F64)
    so = T.solver2d.FlowSolver2d(
        mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(10.0))
    o = so.options
    o.timestep = dt
    o.simulation_export_time = n_steps * dt
    o.simulation_end_time = n_steps * dt
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    so.bnd_functions["shallow_water"] = {1: {"un": Constant(-0.3)},
                                         2: {"elev": Constant(0.0)}}
    so.assign_initial_conditions(uv=torch.tensor([0.3, 0.0], dtype=F64),
                                 elev=0.0)
    return so


def test_forward_gradient_checkpoint_consistency():
    """12 steps: the checkpointed (chunk 4) value to 1e-12 and gradient
    to 1e-8 of the plain ones."""
    n = 12
    so = checkpoint_solver(n)

    def term(state):
        return (state["elev"] ** 2).sum()

    grads = []
    for ck in (False, 4):
        fwd = so.differentiable_forward(
            ["manning_drag_coefficient"], terminal_functional=term,
            n_steps=n, checkpoint=ck)
        c = torch.full((so.mesh2d.nv,), 0.02, dtype=F64, requires_grad=True)
        j = fwd(c)
        (g,) = torch.autograd.grad(j, c)
        grads.append((float(j.detach()), g.numpy()))
    (j0, g0), (j1, g1) = grads
    np.testing.assert_allclose(j1, j0, rtol=1e-12)
    np.testing.assert_allclose(g1, g0, rtol=1e-8, atol=1e-14)


@pytest.mark.slow
def test_long_inversion_gradient_bounded_memory():
    """1000 steps under the default checkpointing (on beyond 128 steps):
    a finite gradient and a Taylor rate above 1.9."""
    n = 1000
    so = checkpoint_solver(n, dt=1.5)

    def term(state):
        return (state["elev"] ** 2).sum() + (state["uv"] ** 2).sum()

    fwd = so.differentiable_forward(
        ["manning_drag_coefficient"], terminal_functional=term, n_steps=n)
    c0 = torch.full((so.mesh2d.nv,), 0.02, dtype=F64)
    rf = ReducedFunctional(fwd, Control(c0))
    assert bool(torch.isfinite(rf.derivative([c0])).all())
    dc = torch.as_tensor(np.random.RandomState(4).rand(so.mesh2d.nv))
    assert taylor_test(rf, c0, dc, h0=1e-3) > 1.9
