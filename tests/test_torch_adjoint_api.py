"""The adjoint's API in ``thetis_tpu_torch.adjoint`` against
``thetis_tpu.adjoint`` (f64, CPU): ``ReducedFunctional`` / ``minimize``
(the bounds forms, callbacks), ``taylor_test``, ``checkpointed_scan``
(value and gradient equal to the plain loop for every chunking), the
inversion toolkit's regularisation calculators and station sampling
against ``jax.grad`` of the reference's, and the checkpointed gradient
of ``differentiable_forward`` against the plain one.

Tolerances: the optimiser's minimum 1e-6 (the reference test's); values
and gradients of the same arithmetic 1e-12 of the largest entry; a
checkpointed gradient equals the plain one to 1e-12 (the replay repeats
the same operations).

The file ends with the reference's inversion and adjoint-checkpointing
tests through the port, each under the reference test's own name and
bounds: ``tests/test_inversion.py`` (station elevations from a 0.05
Manning channel, 16 x 4, 20 CN steps; the friction inverted from a wrong
guess with the port's ``inversion_tools``, ``slow`` as in the reference,
~70 s of L-BFGS-B on the CPU; the gradient's Taylor rate above 1.9,
tier-1) and ``tests/test_checkpointing.py`` (the sqrt-N checkpointing
gives the plain gradient, tier-1; a 1000-step gradient under it passes
the Taylor test, ``slow``).

Then the gradients through the mass PCGs (``solvers/pcg.py::JacobiPCG``
as a transposable linear solve, the reference's ``custom_linear_solve``)
against ``jax.grad`` of the reference's: one explicit dg-cg step (the
CG2 elevation mass inverse is the update), one semi-implicit RT1 x P0 CN
step (the RT mass PCG inside the Newton residual, differentiated twice by
the Newton products) and one CN step of CG1 tracers with SUPG (the CG1
mass PCG in the tracer's residual), each through
``FlowSolver2d.differentiable_forward`` with respect to the initial
state (a seeded velocity, away from the kink of |u.n|), J the sum of the
squared state values.  The set-ups are the parity tests' own
(``test_torch_dgcg.py``, ``test_torch_hdiv.py``,
``test_torch_model2d_tracers.py``): the reference's dg-cg PCG runs on the
port's preconditioner (the reference's lumped one is O(1) off the
inverse, ROADMAP C).  Tolerance 1e-10 of each gradient's largest
entry."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thetis_tpu.adjoint import inversion_tools as jit_tools  # noqa: E402
from thetis_tpu.adjoint.checkpointing import (  # noqa: E402
    checkpointed_scan as j_scan)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch import adjoint as tadj  # noqa: E402
from thetis_tpu_torch.adjoint import inversion_tools as tit_tools  # noqa: E402
from thetis_tpu_torch.adjoint.checkpointing import (  # noqa: E402
    checkpointed_scan as t_scan)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.adjoint import (  # noqa: E402
    Control, ReducedFunctional, taylor_test)
from thetis_tpu_torch.adjoint.inversion_tools import (  # noqa: E402
    GradientRegularizationCalculator, InversionManager,
    StationObservationManager)
from thetis_tpu_torch.utils.constant import Constant  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JSolver  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from test_torch_adjoint_swe import agree  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401
import test_torch_dgcg as dgcg  # noqa: E402
import test_torch_hdiv as hdiv  # noqa: E402
import test_torch_model2d_tracers as tracers  # noqa: E402

F64 = torch.float64


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def test_package_exports():
    assert tadj.__all__ == ["Control", "ReducedFunctional", "taylor_test",
                            "minimize"]
    assert tit_tools.__all__ == jit_tools.__all__
    for name in tit_tools.__all__:
        assert isinstance(getattr(tit_tools, name), type)
    assert T.adjoint is tadj


def test_minimize_bounds_pairs_two_controls():
    """The port's ``test_optimisation.py::
    test_minimize_bounds_pairs_two_controls``: with exactly two control
    entries, scipy-style [(lb, ub), (lb, ub)] bounds are one pair per
    entry, not pyadjoint-style [lb_list, ub_list]."""
    target = torch.tensor([3.0, 42.0], dtype=F64)

    def fwd(c):
        return ((c - target) ** 2).sum()

    rf = tadj.ReducedFunctional(fwd, tadj.Control(
        torch.tensor([1.0, 30.0], dtype=F64)))
    out = tadj.minimize(rf, bounds=[(0.5, 10.0), (5.0, 60.0)],
                        options=dict(maxiter=50))
    np.testing.assert_allclose(out.numpy(), [3.0, 42.0], atol=1e-6)


@pytest.mark.parametrize("form", ["pair", "lists", "pairs"])
def test_minimize_bounds_forms_two_controls(form):
    """Two controls (a vector and a scalar) through each bounds form;
    the optimum sits on a bound for the first entry, as in the
    reference."""
    a0 = np.array([0.2, 0.4, 0.9])
    target = (np.array([0.3, -0.5, 0.8]), 0.25)
    bounds = {"pair": (0.0, 1.0),
              "lists": [[0.0] * 4, [1.0] * 4],
              "pairs": [(0.0, 1.0)] * 4}[form]
    want = [np.clip(target[0], 0.0, 1.0), target[1]]

    def t_fwd(a, b):
        return ((a - torch.tensor(target[0])) ** 2).sum() + (
            b - target[1]) ** 2

    def j_fwd(a, b):
        return jnp.sum((a - jnp.asarray(target[0])) ** 2) + (
            b - target[1]) ** 2

    from thetis_tpu.adjoint import (Control as JC, ReducedFunctional as JRF,
                                    minimize as jmin)
    got = tadj.minimize(tadj.ReducedFunctional(t_fwd, [
        tadj.Control(torch.tensor(a0)), tadj.Control(torch.tensor(0.9))]),
        bounds=bounds, options=dict(maxiter=50))
    ref = jmin(JRF(j_fwd, [JC(jnp.asarray(a0)), JC(jnp.asarray(0.9))]),
               bounds=bounds, options=dict(maxiter=50))
    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)


def test_reduced_functional_callbacks_and_taylor():
    """Values under no_grad, derivatives by autograd, the callbacks with
    the reference's arguments, and the Taylor rate of a smooth map."""
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.standard_normal((5, 5)))
    seen = {"pre": 0, "post": [], "dpre": 0, "dpost": []}

    def fwd(c):
        assert c.requires_grad == torch.is_grad_enabled()
        return torch.tanh(W @ c).pow(2).sum() + (c ** 3).sum()

    rf = tadj.ReducedFunctional(
        fwd, tadj.Control(torch.zeros(5, dtype=F64)), scale=2.0,
        eval_cb_pre=lambda v: seen.__setitem__("pre", seen["pre"] + 1),
        eval_cb_post=lambda j, v: seen["post"].append(j),
        derivative_cb_pre=lambda v: seen.__setitem__("dpre",
                                                     seen["dpre"] + 1),
        derivative_cb_post=lambda j, g, v: seen["dpost"].append(j))
    c = rng.standard_normal(5)
    j = rf(c)
    g = rf.derivative(c)
    jv, gv = rf.value_and_derivative(c)
    ct = torch.tensor(c, requires_grad=True)
    want = 2.0 * fwd(ct)
    (gw,) = torch.autograd.grad(want, ct)
    assert j == jv == pytest.approx(float(want), rel=1e-15)
    close(g, gw.numpy())
    close(gv, gw.numpy())
    assert seen["pre"] == 2 and seen["post"] == [j, j]
    assert seen["dpre"] == 1 and seen["dpost"] == [j, j]
    assert tadj.taylor_test(rf, c, rng.standard_normal(5)) > 1.9


def _recurrence_t(c):
    x, acc = c
    x = torch.tanh(1.1 * x) + 0.01 * torch.roll(x, 1)
    return x, acc + (x ** 2).sum()


def _recurrence_j(c):
    x, acc = c
    x = jnp.tanh(1.1 * x) + 0.01 * jnp.roll(x, 1)
    return x, acc + jnp.sum(x ** 2)


@pytest.mark.parametrize("chunk", [None, 1, 4, 5, 13, 40])
def test_checkpointed_scan_matches_plain_scan(chunk):
    """The port's ``test_checkpointing.py::
    test_checkpointed_scan_matches_plain_scan``: value and gradient of a
    nonlinear recurrence equal the plain loop's for every chunking (a
    non-dividing one among them), and the reference's."""
    x0 = np.linspace(-1.0, 1.0, 32)

    def plain(x):
        c = (x, x.new_zeros(()))
        for _ in range(13):
            c = _recurrence_t(c)
        return c[1]

    xt = torch.tensor(x0, requires_grad=True)
    j0 = plain(xt)
    (g0,) = torch.autograd.grad(j0, xt)
    xt = torch.tensor(x0, requires_grad=True)
    j = t_scan(_recurrence_t, (xt, xt.new_zeros(())), 13, chunk=chunk)[1]
    (g,) = torch.autograd.grad(j, xt)
    assert float(j) == pytest.approx(float(j0), rel=1e-14)
    close(g, g0.numpy(), 1e-13)
    jj, gj = jax.value_and_grad(lambda x: j_scan(
        _recurrence_j, (x, 0.0), 13, chunk=chunk)[1])(jnp.asarray(x0))
    assert float(j) == pytest.approx(float(jj), rel=1e-12)
    close(g, gj, 1e-12)


def test_checkpointed_scan_degenerate_counts():
    x = torch.ones(3)
    assert t_scan(_recurrence_t, (x, 0.0), 0)[0] is x
    out = t_scan(lambda c: c + 1.0, torch.zeros(()), 7, chunk=3)
    assert float(out) == 7.0


@pytest.fixture(scope="module")
def asm_pair():
    jm = jgen.RectangleMesh(6, 4, 3e3, 2e3)
    tm = tgen.RectangleMesh(6, 4, 3e3, 2e3, device="cpu", dtype=F64)
    return (JAsm(jm, JFS(jm, "DG", 1)), TAsm(tm, TFS(tm, "DG", 1)))


@pytest.mark.parametrize("which", ["gradient_cg1", "gradient_dg",
                                   "hessian", "rspace"])
def test_regularization_value_and_gradient(asm_pair, which):
    """Each regularisation calculator's value and gradient against
    ``jax.grad`` of the reference's on the same seeded control."""
    ja, ta = asm_pair
    rng = np.random.default_rng(5)
    nv, nc = ja.mesh.nv, ja.mesh.nc
    c = (rng.standard_normal((nc, 3)) if which == "gradient_dg"
         else rng.standard_normal(nv if which != "rspace" else 3))
    if which.startswith("gradient"):
        jr = jit_tools.GradientRegularizationCalculator(ja, 1e-3, 2.0)
        tr = tit_tools.GradientRegularizationCalculator(ta, 1e-3, 2.0)
    elif which == "hessian":
        jr = jit_tools.HessianRegularizationCalculator(ja, 1e-3, 2.0)
        tr = tit_tools.HessianRegularizationCalculator(ta, 1e-3, 2.0)
    else:
        c0 = np.array([0.1, 0.2, 0.3])
        jr = jit_tools.RSpaceRegularizationCalculator(1e-3, jnp.asarray(c0))
        tr = tit_tools.RSpaceRegularizationCalculator(1e-3, torch.tensor(c0))
    jv, jg = jax.value_and_grad(jr)(jnp.asarray(c))
    ct = torch.tensor(c, requires_grad=True)
    tv = tr(ct)
    (tg,) = torch.autograd.grad(tv, ct)
    assert float(tv) == pytest.approx(float(jv), rel=1e-12)
    assert float(tv) > 0.0
    close(tg, jg)


class _Solver:
    def __init__(self, mesh):
        self.mesh2d = mesh


def test_station_sampling_and_misfit():
    """Owner cells and barycentric weights (a station on a vertex, one
    inside, one outside the domain), the sampled elevation, and the
    misfit functional's value and gradient against the reference's."""
    jm = jgen.RectangleMesh(6, 4, 3e3, 2e3)
    tm = tgen.RectangleMesh(6, 4, 3e3, 2e3, device="cpu", dtype=F64)
    names, xs, ys = ["a", "b", "c"], [500.0, 1234.5, 3100.0], [500.0, 777.0,
                                                              900.0]
    times = [np.linspace(0.0, 100.0, 11)] * 3
    rng = np.random.default_rng(9)
    vals = [rng.standard_normal(11) for _ in names]
    jsta = jit_tools.StationObservationManager(_Solver(jm))
    tsta = tit_tools.StationObservationManager(_Solver(tm))
    for sta in (jsta, tsta):
        sta.register_observation_data(names, "elev", times, vals, xs, ys)
        sta.construct_evaluator()
    np.testing.assert_array_equal(tsta.cell_ids.numpy(),
                                  np.asarray(jsta.cell_ids))
    close(tsta.bary, jsta.bary)
    elev = rng.standard_normal((jm.nc, 3))
    jf = jsta.misfit_step_functional(12.5, 6)
    tf = tsta.misfit_step_functional(12.5, 6)
    for t in (0.0, 12.5, 50.0, 62.5):
        jv, jg = jax.value_and_grad(
            lambda e: jf({"elev": e}, {}, t))(jnp.asarray(elev))
        et = torch.tensor(elev, requires_grad=True)
        tv = tf({"elev": et}, {}, t)
        (tg,) = torch.autograd.grad(tv, et)
        assert float(tv) == pytest.approx(float(jv), rel=1e-12)
        close(tg, jg)


# -- tests/test_inversion.py ------------------------------------------------
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


# -- gradients through the mass PCGs -----------------------------------------
def sum_squares(st):
    return sum((v ** 2).sum() for v in st.values())


def state_gradients(ref, port, names, values, functional=sum_squares):
    """Both packages' gradients of ``functional`` of the state after one
    step, with respect to the named initial-state controls."""
    import jax

    fr = ref.differentiable_forward(names, terminal_functional=functional,
                                    n_steps=1)
    fp = port.differentiable_forward(names, terminal_functional=functional,
                                     n_steps=1)
    jv, jg = jax.jit(jax.value_and_grad(fr, argnums=tuple(
        range(len(names)))))(*[jnp.asarray(v) for v in values])
    ts = [torch.tensor(v, requires_grad=True) for v in values]
    tv = fp(*ts)
    tg = torch.autograd.grad(tv, ts)
    return (float(tv.detach()), [g.numpy() for g in tg]), (
        float(jv), [np.asarray(g) for g in jg])


def initial(s, *keys, seed=0):
    """The initial state's arrays, with a seeded velocity: a fluid at
    rest puts the Lax-Friedrichs flux's |u.n| at its kink, where the two
    packages' derivatives of |x| differ (0 in torch, 1 in JAX)."""
    st = s._get_state()
    rng = np.random.default_rng(seed)
    out = []
    for k in keys:
        v = np.asarray(st[k.replace("initial_", "")])
        out.append(0.05 * rng.standard_normal(v.shape)
                   if k == "initial_uv" else v)
    return out


def test_dgcg_explicit_step_gradient():
    ref = dgcg.reference_solver("SSPRK33", 1, dt=1.0)
    port = flowsolver2d_from_reference(ref, T.RectangleMesh(
        dgcg.NX, dgcg.NY, dgcg.LX, dgcg.LY, device="cpu"))
    ref.eq_sw._lumped = jnp.asarray(port.eq_sw.mass_diag.numpy())
    names = ["initial_elev", "initial_uv"]
    tp, jp = state_gradients(ref, port, names, initial(ref, *names))
    agree(tp, jp)


def test_rt1_cn_step_gradient():
    ref = hdiv.reference_solver("rt-dg p0", 1)
    port = flowsolver2d_from_reference(
        ref, T.RectangleMesh(10, 2, 5e3, 1e3, device="cpu"))
    assert type(port.function_spaces.U_2d).__name__ == "RTSpace"
    names = ["initial_elev", "initial_uv", "quadratic_drag_coefficient"]
    values = initial(ref, *names[:2]) + [
        np.asarray(ref.options.quadratic_drag_coefficient.data)]
    tp, jp = state_gradients(ref, port, names, values)
    agree(tp, jp)


def test_cg1_tracer_step_gradient():
    jm = jgen.RectangleMesh(8, 4, tracers.LX, tracers.LY)
    ref = JSolver(jm, 20.0 + 5.0 * jm.coords_np[:, 1] / tracers.LY)
    tracers.setup(ref, "cg_supg")
    port = flowsolver2d_from_reference(
        ref, tgen.RectangleMesh(8, 4, tracers.LX, tracers.LY, device="cpu",
                                dtype=torch.float64))
    assert tuple(port.fields.tracer_2d.data.shape) == (jm.nv,)
    names = ["initial_uv", "initial_elev"]
    uv, elev = initial(ref, *names)
    tp, jp = state_gradients(
        ref, port, names, [0.2 + uv, elev],
        functional=lambda st: (st["tracer_2d"] ** 2).sum()
        + (st["salt_2d"] ** 2).sum())
    agree(tp, jp)
