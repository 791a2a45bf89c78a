"""Gradients through the mass PCGs (``solvers/pcg.py::JacobiPCG`` as a
transposable linear solve, the reference's ``custom_linear_solve``) of
``thetis_tpu_torch`` against ``jax.grad`` of ``thetis_tpu`` (f64, CPU):
one explicit dg-cg step (the CG2 elevation mass inverse is the update),
one semi-implicit RT1 x P0 CN step (the RT mass PCG inside the Newton
residual, differentiated twice by the Newton products) and one CN step
of CG1 tracers with SUPG (the CG1 mass PCG in the tracer's residual),
each through ``FlowSolver2d.differentiable_forward`` with respect to
the initial state (a seeded velocity, away from the kink of |u.n|), J
the sum of the squared state values.

The set-ups are the parity tests' own (``test_torch_dgcg.py``,
``test_torch_hdiv.py``, ``test_torch_model2d_tracers.py``): the
reference's dg-cg PCG runs on the port's preconditioner (the
reference's lumped one is O(1) off the inverse, ROADMAP C).  Tolerance
1e-10 of each gradient's largest entry."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JSolver  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from test_torch_adjoint_swe import agree  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401
import test_torch_dgcg as dgcg  # noqa: E402
import test_torch_hdiv as hdiv  # noqa: E402
import test_torch_model2d_tracers as tracers  # noqa: E402


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
