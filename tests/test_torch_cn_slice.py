"""The ported slice as a whole: semi-implicit CrankNicolson steps with the
assembled ring solve, entered as ``bench.py`` enters it
(``get_stepper("CrankNicolson", eq, dt, semi_implicit=True,
assembled_solve=True, ...)`` then ``advance``), ``thetis_tpu_torch``
against ``thetis_tpu`` from the same numpy state (f64, CPU).

Tolerance rtol 1e-8 (atol 1e-8 x the field's scale): both packages take
the same Krylov path (same restarts, same Arnoldi iteration count, same
breakdown guard) and differ only in summation order, so the Krylov
tolerance (1e-5) never enters the difference; 1e-8 leaves room for that
roundoff growing over 3 steps and is the tolerance of the reference's own
assembled-vs-matrix-free CN test."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations as JSWE)
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
from thetis_tpu.timeintegration.steppers import (  # noqa: E402
    get_stepper as j_get_stepper)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations as TSWE)
from thetis_tpu_torch.solvers.newton import NewtonParameters as TNP  # noqa: E402
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    get_stepper as t_get_stepper)
from thetis_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy, fields_from_numpy)
from thetis_tpu_torch.kernels import ringmv  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LX, LY = 1e4, 8e3
# the bench's solver parameters (bench.py:97-98) and the tight ones of
# tests/test_assembled_pc.py:136-137
PARAMS = {"bench": dict(ksp_rtol=1e-5, ksp_max_it=32, gmres_restart=8),
          "tight": dict(ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=40)}


def opts():
    """The bench's options (bench.py:55-63)."""
    return SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)


def build(kind, params):
    if kind == "rect":
        jm = jgen.RectangleMesh(6, 5, LX, LY)
        tm = tgen.RectangleMesh(6, 5, LX, LY, device="cpu", dtype=F64)
    else:
        jm = jgen.PeriodicRectangleMesh(6, 5, LX, LY, direction="x")
        tm = tgen.PeriodicRectangleMesh(6, 5, LX, LY, direction="x",
                                        device="cpu", dtype=F64)
    jeq = JSWE(jm, JAsm(jm, JFS(jm, "DG", 1)), opts(), 50.0,
               bnd_conditions={})
    teq = TSWE(tm, TAsm(tm, TFS(tm, "DG", 1)), opts(), 50.0,
               bnd_conditions={})
    # wave CFL ~2 by cell hmin, as the bench (bench.py:82)
    dt = 2.0 * float(jm.cell_hmin_np.min()) / np.sqrt(9.81 * 51.0)
    jst = j_get_stepper("CrankNicolson", jeq, dt, semi_implicit=True,
                        assembled_solve=True,
                        solver_parameters=JNP(**PARAMS[params]))
    tst = t_get_stepper("CrankNicolson", teq, dt, semi_implicit=True,
                        assembled_solve=True,
                        solver_parameters=TNP(**PARAMS[params]))
    x = jm.coords_np[jm.cells_np]
    rng = np.random.default_rng(1)
    state = {
        "elev": np.exp(-((x[..., 0] - LX / 2) / 3e3) ** 2
                       - ((x[..., 1] - LY / 2) / 3e3) ** 2),
        "uv": 0.05 * rng.standard_normal((jm.nc, 3, 2)),
    }
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0,
              "quadratic_drag_coefficient": 2.5e-3}
    return jst, tst, state, fields


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("kind,params", [("rect", "bench"),
                                         ("periodic", "bench"),
                                         ("rect", "tight")])
def test_cn_steps_match_reference(kind, params):
    jst, tst, state, fields = build(kind, params)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    a = {k: jnp.asarray(v) for k, v in state.items()}
    b = state_from_numpy(state, "cpu", F64)
    ringmv.reset_launches()
    for _ in range(3):
        a = jst.advance(0.0, a, jf, jf, {})
        b = tst.advance(0.0, b, tf, tf, {})
    assert ringmv.launches() == 0  # CPU tensors take the plain version
    got = state_to_numpy(b)
    for k in ("elev", "uv"):
        assert np.isfinite(got[k]).all()
        close(got[k], a[k])
    # the step moved the state: the comparison is not of two no-ops
    assert np.abs(got["elev"] - state["elev"]).max() > 1e-3


def test_cn_step_with_separate_old_fields():
    """``fields_old`` a different dict: the stepper evaluates the explicit
    residual separately instead of taking it from the assembly."""
    jst, tst, state, fields = build("rect", "bench")
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    jf_old = dict(jf)
    tf = fields_from_numpy(fields, "cpu", F64)
    tf_old = dict(tf)
    a = jst.advance(0.0, {k: jnp.asarray(v) for k, v in state.items()},
                    jf, jf_old, {})
    b = tst.advance(0.0, state_from_numpy(state, "cpu", F64), tf, tf_old,
                    {})
    got = state_to_numpy(b)
    for k in ("elev", "uv"):
        close(got[k], a[k])


def test_unported_paths_raise(tmp_path):
    """Nothing of the 2D model is left unported.  Every element family is
    ported (A8): the dg-cg elevation is the CG P2 space, and each family
    initializes; the adjoint (A9) is ported
    (``test_assembled_step_gradient``); the HDF5 restart (A10), which
    raised last, restores each family's checkpoint."""
    from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d

    _, tst, _, _ = build("rect", "bench")
    eq = tst.equation
    assert TFS(eq.mesh, "CG", 2).node_count == eq.mesh.nv + eq.mesh.nf
    for family in ("dg-cg", "rt-dg", "bdm-dg"):
        s = FlowSolver2d(eq.mesh, 50.0)
        s.options.no_exports = False
        s.options.fields_to_export = []
        s.options.output_directory = str(tmp_path / family)
        s.options.timestep = 1.0
        s.options.element_family = family
        s.initialize()
        s.export()
        saved = {k: v.clone() for k, v in s._get_state().items()}
        for k in ("uv_2d", "elev_2d"):
            s.fields[k].data = s.fields[k].data + 1.0
        s.load_state(0)
        for k, v in s._get_state().items():
            assert torch.equal(v, saved[k]), (family, k)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_assembled_step_gradient(kind):
    """The slice's assembled CN step (the ring solve's implicit-function
    adjoint and the ring matvec's backward) is differentiable: the
    gradient of the squared new state with respect to the old state and
    the drag agrees with a central difference along a seeded direction
    (the solve tight: 1e-6)."""
    _, tst, state, fields = build(kind, "tight")
    u0 = state_from_numpy(state, "cpu", F64)
    rng = np.random.default_rng(8)
    d = {k: torch.tensor(0.01 * rng.standard_normal(tuple(v.shape)))
         for k, v in u0.items()}
    drag = torch.tensor(2.5e-3, dtype=F64)

    def J(u, cd):
        f = dict(fields, quadratic_drag_coefficient=cd)
        out = tst.advance(0.0, u, f, f, {})
        return sum((v ** 2).sum() for v in out.values())

    us = {k: v.clone().requires_grad_(True) for k, v in u0.items()}
    cd = drag.clone().requires_grad_(True)
    val = J(us, cd)
    grads = torch.autograd.grad(val, list(us.values()) + [cd])
    assert all(torch.isfinite(g).all() for g in grads)
    assert tst.stats["adjoint_ksp_cycles"] >= 1
    h = 1e-4
    with torch.no_grad():
        fd = (float(J({k: v + h * d[k] for k, v in u0.items()}, drag))
              - float(J({k: v - h * d[k] for k, v in u0.items()}, drag))
              ) / (2 * h)
        fd_c = (float(J(u0, drag + 1e-7)) - float(J(u0, drag - 1e-7))) / 2e-7
    got = sum(float((g * d[k]).sum()) for g, k in zip(grads, us))
    assert got == pytest.approx(fd, rel=1e-6)
    assert float(grads[-1]) == pytest.approx(fd_c, rel=1e-5)