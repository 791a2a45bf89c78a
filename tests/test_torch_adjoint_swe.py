"""``FlowSolver2d.differentiable_forward`` of ``thetis_tpu_torch`` against
``jax.grad`` of ``thetis_tpu``'s (f64, CPU), through the implicit
solves' adjoints: SteadyState (the dense Newton's transposed Jacobian,
``tests/test_adjoint_swe.py::test_gradient_from_adjoint[SteadyState]``'s
setup) and the matrix-free Newton CrankNicolson under the mass
preconditioner (FGMRES on ``J^T`` products), each with a Taylor rate
above 1.9 through the port's ``ReducedFunctional``; the Newton CN under
the assembled wave preconditioner (whose transpose the port uses for the
adjoint, where the reference's reuse of it stalls) and the assembled CN
under the port's per-field coarse correction (which the reference does
not have) by their Taylor rates alone.  The reference's 4-step CN and
initial-elevation cases run under ``-m slow``, as in the reference.

The reference solver is built by the reference test's own set-up (or by
``test_torch_flowsolver2d``'s) and carried to the port by
``interop.flowsolver2d_from_reference``; both packages run the same
Krylov path, so the gradients agree to 1e-10 of their largest entry.
:func:`check_assembled_cn_gradient` holds the assembled CN's gradient
(the ring solve's implicit-function adjoint) to the reference's, for
``test_torch_model2d.py`` (the coarse correction) and
``test_torch_solvers2d.py`` (the Schur fieldsplit)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thetis_tpu_torch.solvers.assembled as tas  # noqa: E402
from thetis_tpu_torch.adjoint import (  # noqa: E402
    Control, ReducedFunctional, taylor_test)
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from test_adjoint_swe import basic_setup  # noqa: E402
from test_torch_flowsolver2d import (  # noqa: E402
    C0, HMIN, one_torch_thread, meshes, reference_solver)

F64 = torch.float64


def port_of(ref, nx, ny, lx, ly):
    return flowsolver2d_from_reference(
        ref, tgen.RectangleMesh(nx, ny, lx, ly, device="cpu", dtype=F64))


def gradients(ref, port, names, functional, n, values):
    """``(J, grads)`` of both packages' ``differentiable_forward`` at the
    same numpy control values: ``jax.grad`` (jitted) of the reference's,
    ``torch.autograd.grad`` of the port's."""
    fr = ref.differentiable_forward(
        names, terminal_functional=lambda s: functional(s, ref.asm),
        n_steps=n)
    fp = port.differentiable_forward(
        names, terminal_functional=lambda s: functional(s, port.asm),
        n_steps=n)
    jv, jg = jax.jit(jax.value_and_grad(fr, argnums=tuple(
        range(len(names)))))(*[jnp.asarray(v) for v in values])
    ts = [torch.tensor(v, requires_grad=True) for v in values]
    tv = fp(*ts)
    tg = torch.autograd.grad(tv, ts)
    return (float(tv.detach()), [g.numpy() for g in tg]), (
        float(jv), [np.asarray(g) for g in jg]), fp


def agree(port, ref, rtol=1e-10):
    (tv, tg), (jv, jg) = port, ref
    assert tv == pytest.approx(jv, rel=rtol)
    for g, want in zip(tg, jg):
        assert np.isfinite(g).all() and np.abs(want).max() > 0.0
        np.testing.assert_allclose(g, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


def u_integral(s, asm):
    return asm.integrate(s["uv"][..., 0])


def u_integral_elev_l2(s, asm):
    return asm.integrate(s["uv"][..., 0]) + asm.norm_l2(s["elev"]) ** 2


ASSEMBLED_PARAMS = dict(ksp_rtol=1e-10, ksp_max_it=400, gmres_restart=40)


class PerDofCoarse(tas.CoarseCorrection):
    """The reference's coarse space whatever the solver asks for."""

    def __init__(self, blocks, ring, mesh, target_size=None, fields=None):
        super().__init__(blocks, ring, mesh, target_size=target_size)


def check_assembled_cn_gradient(config, monkeypatch):
    """The assembled semi-implicit CN's gradient through
    ``differentiable_forward`` against ``jax.grad`` of the reference's:
    one step on ``test_torch_flowsolver2d``'s 12x6 rectangle, with
    respect to the drag field and the initial elevation, under the
    two-level coarse correction (``cn_coarse``) or the Schur fieldsplit
    (``cn_schur``, the port's counterpart of the reference's ``slow``
    ``test_assembled_pc.py::test_fieldsplit_cn_step_and_gradient``).

    The coarse case runs both packages on the reference's coarse space
    (one coarse dof per aggregate and packed component, patched into the
    port's solver) at a wave CFL of 4.5, where that space converges; the
    port's own per-field space is held by its Taylor rate in this
    file.  Both
    packages solve to 1e-10 on the same Krylov path: the gradients agree
    to 1e-10 of their largest entry."""
    jm, tm = meshes("rect")
    dt = 9.0 * HMIN / C0 if config == "cn_coarse" else None
    ref = reference_solver(jm, "rect", config, dt=dt, params=ASSEMBLED_PARAMS)
    if config == "cn_coarse":
        monkeypatch.setattr(tas, "CoarseCorrection", PerDofCoarse)
    port = flowsolver2d_from_reference(ref, tm)
    want = {"cn_coarse": "CoarseCorrection",
            "cn_schur": "SchurFieldsplitPC"}[config]
    assert type(ref.timestepper.coarse).__name__ == want
    assert want in [c.__name__ for c in
                    type(port.timestepper.coarse).__mro__]
    rng = np.random.RandomState(3)
    c = 2.5e-3 * (1.0 + rng.rand(jm.nv))
    e0 = np.asarray(ref.fields.elev_2d.data)
    tp, jp, _ = gradients(ref, port, ["quadratic_drag_coefficient",
                                      "initial_elev"],
                          u_integral_elev_l2, 1, [c, e0])
    agree(tp, jp)
    st = port.timestepper.stats
    assert st["ksp_rel_residual"] < 1e-8
    assert st["adjoint_ksp_cycles"] >= 1


def test_steady_state_gradient_matches_reference():
    """The reference test's SteadyState case (10x5, dense Newton with a
    line search): the gradient of the domain integral of u with respect
    to the quadratic drag field, and the port's Taylor rate."""
    ref = basic_setup("SteadyState")
    port = port_of(ref, 10, 5, 100.0, 50.0)
    rng = np.random.RandomState(42)
    c = rng.rand(ref.mesh2d.nv)
    dc = rng.rand(ref.mesh2d.nv)
    tp, jp, fp = gradients(ref, port, ["quadratic_drag_coefficient"],
                           u_integral, 1, [c])
    agree(tp, jp)
    rf = ReducedFunctional(fp, Control(port.options.quadratic_drag_coefficient))
    assert taylor_test(rf, c, dc, h0=5e-2) > 1.9


TIGHT_NEWTON = dict(snes_rtol=1e-12, snes_atol=1e-14, snes_max_it=20,
                    ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=40)


def newton_pair(pc):
    """``test_torch_flowsolver2d``'s 12x6 rectangle under the matrix-free
    Newton CN with preconditioner ``pc`` (the option's value; None is the
    facade's assembled wave PC)."""
    jm, tm = meshes("rect")
    ref = reference_solver(jm, "rect", "cn_newton", params=TIGHT_NEWTON)
    if pc is not None:
        ref.options.swe_timestepper_options.preconditioner = pc
        ref.create_timestepper()
    return jm, ref, flowsolver2d_from_reference(ref, tm)


def test_newton_cn_gradient_matches_reference():
    """One matrix-free Newton CN step under the mass preconditioner
    (symmetric: both packages precondition the adjoint's ``J^T`` solve
    with it), the gradient with respect to the drag field and the initial
    elevation, and the port's Taylor rate in the elevation (one step's
    drag term moves J by too little for its second-order remainder to
    rise above the Newton solve's roundoff)."""
    jm, ref, port = newton_pair("mass")
    assert port.timestepper.preconditioner == "mass"
    rng = np.random.RandomState(7)
    c = 2.5e-3 * (1.0 + rng.rand(jm.nv))
    e0 = np.asarray(ref.fields.elev_2d.data)
    tp, jp, fp = gradients(ref, port, ["quadratic_drag_coefficient",
                                       "initial_elev"],
                           u_integral_elev_l2, 1, [c, e0])
    agree(tp, jp)
    st = port.timestepper.stats
    assert st["newton_iterations"] >= 2
    assert st["adjoint_ksp_rel_residual"] < 1e-10
    rf = ReducedFunctional(lambda e: fp(torch.tensor(c), e),
                           Control(torch.tensor(e0)))
    assert taylor_test(rf, e0, 0.1 * rng.rand(*e0.shape), h0=0.5) > 1.9


def test_newton_cn_assembled_wave_pc_adjoint():
    """Under the facade's assembled wave PC the port preconditions the
    adjoint with the PC's transpose (the blocks of ``W^T``), converges
    and passes the Taylor test.  The reference reuses ``W`` for ``J^T``,
    where its FGMRES stalls (ROADMAP C), so here the packages part."""
    jm, ref, port = newton_pair(None)
    pc = port.timestepper.preconditioner
    assert type(pc).__name__ == "AssembledWavePC"
    assert pc.transpose().transpose() is pc
    fp = port.differentiable_forward(
        ["initial_elev"],
        terminal_functional=lambda s: u_integral_elev_l2(s, port.asm),
        n_steps=1)
    e0 = port.fields.elev_2d.data.clone()
    rf = ReducedFunctional(fp, Control(e0))
    rf.derivative(e0)
    st = port.timestepper.stats
    assert st["adjoint_ksp_rel_residual"] < 1e-10
    rng = np.random.RandomState(7)
    assert taylor_test(rf, e0, 0.1 * rng.rand(*e0.shape), h0=0.5) > 1.9


def test_assembled_cn_per_field_coarse_taylor():
    """The port's own two-level preconditioner (per-field aggregate
    constants; the reference's per-dof space stalls here, ROADMAP C): the
    gradient through its transposed V-cycle passes the Taylor test in the
    drag and in the initial elevation."""
    jm, tm = meshes("rect")
    ref = reference_solver(jm, "rect", "cn_coarse", params=dict(
        ksp_rtol=1e-11, ksp_max_it=400, gmres_restart=40))
    port = flowsolver2d_from_reference(ref, tm)
    assert type(port.timestepper.coarse).__name__ == "CoarseCorrection"
    assert port.timestepper.coarse.F is not None
    fp = port.differentiable_forward(
        ["quadratic_drag_coefficient", "initial_elev"],
        terminal_functional=lambda s: u_integral_elev_l2(s, port.asm),
        n_steps=1)
    rng = np.random.RandomState(5)
    c = torch.tensor(2.5e-3 * (1.0 + rng.rand(jm.nv)))
    e0 = port.fields.elev_2d.data.clone()
    rf_c = ReducedFunctional(lambda d: fp(d, e0), Control(c))
    assert taylor_test(rf_c, c, 2.5e-3 * rng.rand(jm.nv), h0=0.5) > 1.9
    rf_e = ReducedFunctional(lambda e: fp(c, e), Control(e0))
    assert taylor_test(rf_e, e0, 0.1 * rng.rand(*e0.shape), h0=0.5) > 1.9


@pytest.mark.slow
def test_cn_gradient_from_adjoint_matches_reference():
    """``tests/test_adjoint_swe.py::test_gradient_from_adjoint
    [CrankNicolson]``'s case (4 steps of the assembled CN, theta 1)
    through both packages, and the port's Taylor rate."""
    ref = basic_setup("CrankNicolson")
    port = port_of(ref, 16, 8, 100.0, 50.0)
    rng = np.random.RandomState(42)
    c = rng.rand(ref.mesh2d.nv)
    dc = rng.rand(ref.mesh2d.nv)
    tp, jp, fp = gradients(ref, port, ["quadratic_drag_coefficient"],
                           u_integral, 4, [c])
    agree(tp, jp)
    rf = ReducedFunctional(fp, Control(torch.tensor(c)))
    assert taylor_test(rf, c, dc, h0=5e-2) > 1.9


@pytest.mark.slow
def test_gradient_wrt_initial_elevation_matches_reference():
    """``tests/test_adjoint_swe.py::test_gradient_wrt_initial_elevation``
    (3 CN steps, J the squared L2 norm of the elevation)."""
    ref = basic_setup("CrankNicolson")
    port = port_of(ref, 16, 8, 100.0, 50.0)
    elev0 = np.asarray(ref.fields.elev_2d.data)
    rng = np.random.RandomState(1)
    c = 0.1 * rng.rand(*elev0.shape)
    dc = rng.rand(*elev0.shape)
    tp, jp, fp = gradients(ref, port, ["initial_elev"],
                           lambda s, asm: asm.norm_l2(s["elev"]) ** 2, 3,
                           [c])
    agree(tp, jp)
    rf = ReducedFunctional(fp, Control(torch.tensor(c)))
    assert taylor_test(rf, c, dc, h0=1e-2) > 1.9
