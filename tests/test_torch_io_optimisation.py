"""The optimisation callbacks and the field diagnostics, ``thetis_tpu_torch``
against ``thetis_tpu`` (f64, CPU).

* ``tests/test_optimisation.py``'s three cases over the port's adjoint
  (``Control``, ``ReducedFunctional``, ``minimize``): the callbacks'
  functional history and their exported controls and derivatives match
  the reference's run of the same case, ``UserExportManager`` writes the
  same file, and two-control bounds pair as in the reference.
* ``VorticityCalculator2D``, ``KineticEnergyCalculator``,
  ``form2indicator`` and ``DWRErrorEstimator`` on a seeded state of a
  RectangleMesh(6, 3) solver.

* The inversion toolkit through the port's adjoint:
  ``InversionManager``'s cost function on ``examples/channel_inversion``
  reduced to 8x2 and 3 steps (the station misfit and the gradient
  regularisation, with respect to the Manning field): value and
  gradient against ``jax.grad``, the consistency and Taylor tests, and
  ``minimize`` lowering J and saving its progress.  The reference's
  solver is built as the example builds it and carried to the port by
  ``interop``.

Tolerances: the optimisation's functional values and exported arrays
1e-10 relative (L-BFGS-B on the same exact gradients, their sums in two
orders); the diagnostics 1e-12 relative; the inversion's value and
gradient 1e-10 of the largest entry."""
import glob
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thetis_tpu as jpkg  # noqa: E402
import thetis_tpu.adjoint as jadj  # noqa: E402
from thetis_tpu.adjoint import inversion_tools as jit_tools  # noqa: E402
import thetis_tpu.model.diagnostics as jdiag  # noqa: E402
import thetis_tpu.model.optimisation as jopt  # noqa: E402
import thetis_tpu_torch.adjoint as tadj  # noqa: E402
from thetis_tpu_torch.adjoint import inversion_tools as tit_tools  # noqa: E402
import thetis_tpu_torch.model.diagnostics as tdiag  # noqa: E402
import thetis_tpu_torch.model.optimisation as topt  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TSpace)
from thetis_tpu_torch.mesh.generation import (  # noqa: E402
    RectangleMesh as TRect)
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402
from test_torch_adjoint_swe import agree  # noqa: E402

F64 = torch.float64
OPT_RTOL = 1e-10
DIAG_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def run_callbacks(pkg, outdir):
    """test_optimisation.py::test_optimisation_callbacks through one
    package: returns (optimum, functional history)."""
    if pkg == "port":
        mesh = TRect(4, 4, 1.0, 1.0, device="cpu", dtype=F64)
        V = TSpace(mesh, "CG", 1)
        target = TFunction(V).interpolate(lambda x, y: x * (1 - x))
        c0 = TFunction(V, name="control")
        adj, opt = tadj, topt

        def forward(c):
            return torch.sum((c - target.data) ** 2)
    else:
        mesh = jpkg.RectangleMesh(4, 4, 1.0, 1.0)
        V = jpkg.FunctionSpace(mesh, "CG", 1)
        target = jpkg.Function(V).interpolate(lambda x, y: x * (1 - x))
        c0 = jpkg.Function(V, name="control")
        adj, opt = jadj, jopt

        def forward(c):
            return jnp.sum((c - target.data) ** 2)

    func_cb = opt.FunctionalOptimisationCallback()
    deriv_cb = opt.OptimisationCallbackList([
        opt.DerivativesExportOptimisationCallback(outdir)])
    controls_cb = opt.ControlsExportOptimisationCallback(outdir)
    rf = adj.ReducedFunctional(
        forward, adj.Control(c0),
        eval_cb_post=lambda j, vals: (func_cb(j, vals),
                                      controls_cb(j, vals)),
        derivative_cb_post=deriv_cb)
    optimum = adj.minimize(rf, options={"maxiter": 5})
    return np.asarray(optimum), func_cb.history, np.asarray(target.data)


def test_optimisation_callbacks(tmp_path):
    t_opt, t_hist, target = run_callbacks("port", str(tmp_path / "t"))
    j_opt, j_hist, _ = run_callbacks("ref", str(tmp_path / "j"))
    assert np.allclose(t_opt, target, atol=1e-4)
    assert len(t_hist) >= 2 and t_hist[-1] < t_hist[0]
    assert len(t_hist) == len(j_hist)
    assert rel(t_hist, j_hist) <= OPT_RTOL
    assert rel(t_opt, j_opt) <= OPT_RTOL
    for kind in ("control", "derivative"):
        tf = sorted(os.path.basename(f) for f in glob.glob(
            str(tmp_path / "t" / f"*{kind}*")))
        jf = sorted(os.path.basename(f) for f in glob.glob(
            str(tmp_path / "j" / f"*{kind}*")))
        assert tf == jf and tf
        for fn in tf:
            with np.load(tmp_path / "t" / fn) as a, \
                    np.load(tmp_path / "j" / fn) as b:
                assert rel(a["data"], b["data"]) <= OPT_RTOL


def test_user_export_manager(tmp_path):
    jm = jpkg.RectangleMesh(3, 3, 1.0, 1.0)
    jf = jpkg.Function(jpkg.FunctionSpace(jm, "DG", 1),
                       name="my_diag").assign(2.5)
    tm = TRect(3, 3, 1.0, 1.0, device="cpu", dtype=F64)
    tf = TFunction(TSpace(tm, "DG", 1), name="my_diag").assign(2.5)
    jopt.UserExportManager(str(tmp_path / "j"), [jf]).export()
    topt.UserExportManager(str(tmp_path / "t"), [tf]).export()
    names = sorted(os.path.relpath(f, tmp_path / "t") for f in glob.glob(
        str(tmp_path / "t" / "**" / "*my_diag*"), recursive=True))
    assert names == sorted(
        os.path.relpath(f, tmp_path / "j") for f in glob.glob(
            str(tmp_path / "j" / "**" / "*my_diag*"), recursive=True))
    assert names
    with np.load(tmp_path / "t" / "my_diag_00000.npz") as a, \
            np.load(tmp_path / "j" / "my_diag_00000.npz") as b:
        assert np.array_equal(a["data"], b["data"])


def test_minimize_bounds_pairs_two_controls():
    """tests/test_optimisation.py::test_minimize_bounds_pairs_two_controls
    on the port: scipy-style pairs for exactly two control entries."""
    target = torch.tensor([3.0, 42.0], dtype=F64)
    rf = tadj.ReducedFunctional(
        lambda c: torch.sum((c - target) ** 2),
        tadj.Control(torch.tensor([1.0, 30.0], dtype=F64)))
    out = tadj.minimize(rf, bounds=[(0.5, 10.0), (5.0, 60.0)],
                        options=dict(maxiter=50))
    np.testing.assert_allclose(out.numpy(), [3.0, 42.0], atol=1e-6)


# -- diagnostics -----------------------------------------------------
@pytest.fixture(scope="module")
def solvers():
    js = jpkg.solver2d.FlowSolver2d(jpkg.RectangleMesh(6, 3, 6e3, 3e3),
                                    12.0)
    ts = FlowSolver2d(TRect(6, 3, 6e3, 3e3, device="cpu", dtype=F64), 12.0)
    for s in (js, ts):
        s.options.no_exports = True
        s.options.swe_timestepper_type = "SSPRK33"
        s.options.timestep = 10.0
        s.initialize()
    rng = np.random.default_rng(0)
    nc = js.mesh2d.nc
    st = dict(uv=0.3 * rng.standard_normal((nc, 3, 2)),
              elev=0.2 * rng.standard_normal((nc, 3)))
    adj = dict(uv=rng.standard_normal((nc, 3, 2)),
               elev=rng.standard_normal((nc, 3)))
    return js, ts, st, adj


def as_j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def test_vorticity(solvers):
    js, ts, st, _ = solvers
    got = tdiag.VorticityCalculator2D(ts.asm).solve(torch.as_tensor(
        st["uv"]))
    ref = jdiag.VorticityCalculator2D(js.asm).solve(jnp.asarray(st["uv"]))
    assert got.shape == (ts.mesh2d.nv,)
    assert rel(got.numpy(), ref) <= DIAG_RTOL


def test_kinetic_energy(solvers):
    js, ts, st, _ = solvers
    got = tdiag.KineticEnergyCalculator(
        ts.asm, ts.depth, ts.eq_sw.bathy_q).compute(
            torch.as_tensor(st["uv"]), torch.as_tensor(st["elev"]))
    ref = jdiag.KineticEnergyCalculator(
        js.asm, js.depth, js.eq_sw.bathy_q).compute(
            jnp.asarray(st["uv"]), jnp.asarray(st["elev"]))
    assert float(got) == pytest.approx(float(ref), rel=DIAG_RTOL)


def test_form2indicator(solvers):
    js, ts, _, _ = solvers
    q = np.random.default_rng(1).standard_normal(tuple(ts.asm.wdetJ.shape))
    got = tdiag.form2indicator(ts.asm, torch.as_tensor(q))
    ref = jdiag.form2indicator(js.asm, jnp.asarray(q))
    assert got.shape == (ts.mesh2d.nc,)
    assert rel(got.numpy(), ref) <= DIAG_RTOL


def test_dwr_indicator(solvers):
    js, ts, st, adj = solvers
    got = tdiag.DWRErrorEstimator(ts).compute(as_t(st), as_t(adj))
    ref = jdiag.DWRErrorEstimator(js).compute(as_j(st), as_j(adj))
    assert got.shape == (ts.mesh2d.nc,) and float(got.min()) >= 0.0
    assert rel(got.numpy(), ref) <= DIAG_RTOL


# -- the inversion toolkit (examples/channel_inversion) ---------------
LX, LY, NX, NY, STEPS = 20e3, 2e3, 8, 2, 3
STATIONS = dict(names=["A", "B", "C", "D"], x=[2.5e3, 7.5e3, 12.5e3, 17.5e3],
                y=[1e3] * 4)


def channel(manning):
    """``examples/channel_inversion``'s ``make_solver`` at 8x2 and 3
    steps (the reference), and the port's copy of it."""
    jm = jpkg.RectangleMesh(NX, NY, LX, LY)
    p1 = jpkg.FunctionSpace(jm, "CG", 1)
    so = jpkg.solver2d.FlowSolver2d(jm, jpkg.Function(p1).assign(20.0))
    o = so.options
    o.timestep = 30.0
    o.simulation_export_time = 30.0 * STEPS
    o.simulation_end_time = 30.0 * STEPS
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.manning_drag_coefficient = jpkg.Function(
        p1, data=jnp.full((jm.nv,), float(manning)))
    so.bnd_functions["shallow_water"] = {1: {"un": jpkg.Constant(-0.5)},
                                         2: {"elev": jpkg.Constant(0.0)}}
    so.assign_initial_conditions(uv=jnp.asarray([0.5, 0.0]), elev=0.0)
    port = flowsolver2d_from_reference(so, TRect(NX, NY, LX, LY,
                                                 device="cpu", dtype=F64))
    return so, port


def managers(so, port, tools):
    """An InversionManager of each package over the same seeded
    observation series (4 stations, 2 cm elevations)."""
    rng = np.random.default_rng(21)
    times = [30.0 * np.arange(STEPS + 2)] * 4
    values = [0.02 * rng.standard_normal(STEPS + 2) for _ in range(4)]
    out = []
    for s, mod, asm in ((so, jit_tools, so.asm), (port, tit_tools, port.asm)):
        sta = mod.StationObservationManager(s)
        sta.register_observation_data(STATIONS["names"], "elev", times,
                                      values, STATIONS["x"], STATIONS["y"])
        sta.construct_evaluator()
        im = mod.InversionManager(sta, real_cost_function_scaling=1e3,
                                  output_dir=str(tools))
        im.add_control("manning_drag_coefficient",
                       s.options.manning_drag_coefficient,
                       regularization=mod.GradientRegularizationCalculator(
                           asm, gamma=1e-4))
        out.append(im)
    return out


def test_channel_inversion_cost_and_gradient(tmp_path):
    so, port = channel(0.02)
    jim, tim = managers(so, port, tmp_path)
    rng = np.random.default_rng(2)
    m = 0.02 + 0.01 * rng.random(so.mesh2d.nv)
    jv, jg = jax.jit(jax.value_and_grad(jim.get_cost_function(STEPS)))(
        jnp.asarray(m))
    tJ = tim.get_cost_function(STEPS)
    mt = torch.tensor(m, requires_grad=True)
    tv = tJ(mt)
    (tg,) = torch.autograd.grad(tv, mt)
    agree((float(tv.detach()), [tg.numpy()]), (float(jv), [np.asarray(jg)]))
    rf = tim.get_reduced_functional(STEPS)
    assert tim.consistency_test()
    assert tim.taylor_test(h0=1e-3) > 1.9
    j0 = rf()
    out = tim.minimize(maxiter=2)
    assert rf([out]) < j0
    saved = np.load(tmp_path / "progress_J.npy")
    assert len(saved) >= 1 and saved[0] == pytest.approx(tim.progress["J"][0])
