"""The inversion toolkit through the port's adjoint against the
reference's (f64, CPU): ``InversionManager``'s cost function on
``examples/channel_inversion`` reduced to 8x2 and 3 steps (the station
misfit and the gradient regularisation, with respect to the Manning
field): value and gradient against ``jax.grad`` (1e-10 of the largest
entry), the consistency and Taylor tests, and ``minimize`` lowering J
and saving its progress.  The reference's solver is built as the example
builds it and carried to the port by ``interop``; the farm functional is
``test_torch_adjoint_farm.py``."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thetis_tpu as J  # noqa: E402
from thetis_tpu.adjoint import inversion_tools as jit_tools  # noqa: E402
from thetis_tpu_torch.adjoint import inversion_tools as tit_tools  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from test_torch_adjoint_swe import agree  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LX, LY, NX, NY, STEPS = 20e3, 2e3, 8, 2, 3
STATIONS = dict(names=["A", "B", "C", "D"], x=[2.5e3, 7.5e3, 12.5e3, 17.5e3],
                y=[1e3] * 4)


def channel(manning):
    """``examples/channel_inversion``'s ``make_solver`` at 8x2 and 3
    steps (the reference), and the port's copy of it."""
    jm = J.RectangleMesh(NX, NY, LX, LY)
    p1 = J.FunctionSpace(jm, "CG", 1)
    so = J.solver2d.FlowSolver2d(jm, J.Function(p1).assign(20.0))
    o = so.options
    o.timestep = 30.0
    o.simulation_export_time = 30.0 * STEPS
    o.simulation_end_time = 30.0 * STEPS
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.manning_drag_coefficient = J.Function(
        p1, data=jnp.full((jm.nv,), float(manning)))
    so.bnd_functions["shallow_water"] = {1: {"un": J.Constant(-0.5)},
                                         2: {"elev": J.Constant(0.0)}}
    so.assign_initial_conditions(uv=jnp.asarray([0.5, 0.0]), elev=0.0)
    port = flowsolver2d_from_reference(so, tgen.RectangleMesh(
        NX, NY, LX, LY, device="cpu", dtype=F64))
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
