"""2D shallow water port: residuals, the analytic ring-block assembly and
the FGMRES core of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64,
CPU), from the same seeded numpy inputs.

Tolerances: residuals rtol 1e-12 and blocks rtol 1e-11, each with an atol
of the same factor times the array's scale (entries that cancel to ~0
differ in the last bits between the two summation orders); FGMRES
rtol 1e-10 (same Krylov path, iterated roundoff)."""
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
from thetis_tpu.equations.swe_blocks import (  # noqa: E402
    assemble_swe_blocks as j_blocks)
from thetis_tpu.solvers.newton import _fgmres_flat as j_fgmres  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations as TSWE)
from thetis_tpu_torch.equations.swe_blocks import (  # noqa: E402
    assemble_swe_blocks as t_blocks)
from thetis_tpu_torch.solvers.newton import _fgmres_flat as t_fgmres  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy, fields_from_numpy, fields_to_numpy,
    bathymetry_from_numpy, bathymetry_to_numpy)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
_WAVE = frozenset(["ExternalPressureGradientTerm", "HUDivTerm"])
# open boundaries of every kind, plus a drag-marked wall
BCS = {1: {"elev": 0.3}, 2: {"un": 0.2}, 3: {"flux": -150.0},
       4: {"drag": 2.5e-3}}
CASES = {
    "rect_bcs": ("rect", BCS),
    "rect_land": ("rect", {}),
    "periodic": ("periodic", {}),
}


def opts():
    return SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


_CACHE = {}


def make(case):
    if case in _CACHE:
        return _CACHE[case]
    kind, bnd = CASES[case]
    if kind == "rect":
        jm = jgen.RectangleMesh(6, 5, 1e4, 8e3)
        tm = tgen.RectangleMesh(6, 5, 1e4, 8e3, device="cpu", dtype=F64)
    else:
        jm = jgen.PeriodicRectangleMesh(6, 5, 1e4, 8e3, direction="x")
        tm = tgen.PeriodicRectangleMesh(6, 5, 1e4, 8e3, direction="x",
                                        device="cpu", dtype=F64)
    rng = np.random.default_rng(3)
    bathy = 20.0 + 5.0 * rng.random(jm.nv)  # CG1 bathymetry
    jeq = JSWE(jm, JAsm(jm, JFS(jm, "DG", 1)), opts(), jnp.asarray(bathy),
               bnd_conditions=bnd)
    teq = TSWE(tm, TAsm(tm, TFS(tm, "DG", 1)), opts(),
               bathymetry_from_numpy(bathy, "cpu", F64), bnd_conditions=bnd)
    state = {"uv": rng.normal(0, 0.3, (jm.nc, 3, 2)),
             "elev": rng.normal(0, 0.2, (jm.nc, 3))}
    lagged = {"uv": rng.normal(0, 0.3, (jm.nc, 3, 2)),
              "elev": rng.normal(0, 0.2, (jm.nc, 3))}
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0,
              "quadratic_drag_coefficient": 2.5e-3,
              "coriolis": rng.normal(0, 1e-4, (jm.nv,)),
              "viscosity_h": 5.0,
              "wind_stress": rng.normal(0, 0.1, (jm.nc, 3, 2)),
              "volume_source": rng.normal(0, 1e-5, (jm.nc, 3))}
    _CACHE[case] = (jeq, teq, bnd, state, lagged, fields)
    return _CACHE[case]


def jstate(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def tstate(d):
    return state_from_numpy(d, "cpu", F64)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("label", ["all", "wave", "implicit", "source"])
def test_residual(case, label):
    jeq, teq, bnd, state, lagged, fields = make(case)
    lab = _WAVE if label == "wave" else label
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    want = jeq.residual(lab, jstate(state), jstate(lagged), jf, jf, bnd)
    got = state_to_numpy(teq.residual(lab, tstate(state), tstate(lagged),
                                      tf, tf, bnd))
    for k in ("uv", "elev"):
        close(got[k], want[k], 1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mass_operators(case):
    jeq, teq, bnd, state, lagged, fields = make(case)
    for meth in ("mass_term", "mass_inverse"):
        want = getattr(jeq, meth)(jstate(state))
        got = getattr(teq, meth)(tstate(state))
        for k in ("uv", "elev"):
            close(got[k], want[k], 1e-12)


@pytest.mark.parametrize("case", ["rect_bcs", "periodic"])
def test_assemble_swe_blocks(case):
    """Blocks of ``M - theta dt dR/du`` and the primal residual, against
    the reference's slab-unrolled assembly (component-major layout)."""
    jeq, teq, bnd, state, lagged, fields = make(case)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    coeff = 0.55 * 40.0
    A_j, r_j = j_blocks(jeq, jstate(lagged), jf, bnd, coeff,
                        return_residual=True, layout="T")
    A_t, r_t = t_blocks(teq, tstate(lagged), tf, bnd, coeff,
                        return_residual=True)
    assert A_t.shape == (4, 9, 9, teq.mesh.nc) and A_t.is_contiguous()
    close(A_t, A_j, 1e-11)
    for k in ("uv", "elev"):
        close(r_t[k], r_j[k], 1e-11)
    # the primal residual is the residual at the lagged state
    r_direct = teq.residual("all", tstate(lagged), tstate(lagged), tf, tf,
                            bnd)
    for k in ("uv", "elev"):
        close(r_t[k], r_direct[k].numpy(), 1e-12)


def _system(n, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    return A, b, dinv


@pytest.mark.parametrize("restart,max_cycles,rtol", [
    (8, 4, 1e-5), (5, 10, 1e-12), (12, 1, 1e-3)])
def test_fgmres_matches_reference(restart, max_cycles, rtol):
    A, b, dinv = _system(60, restart)
    xj, rj, bj = j_fgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                          lambda v: jnp.asarray(dinv) * v, rtol, restart,
                          max_cycles)
    At, dt_ = torch.tensor(A), torch.tensor(dinv)
    xt, rt, bt = t_fgmres(lambda v: At @ v, torch.tensor(b),
                          lambda v: dt_ * v, rtol, restart, max_cycles)
    close(xt, xj, 1e-10)
    np.testing.assert_allclose(rt, float(rj), rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(bt, float(bj), rtol=1e-14)
    # the projected residual is the true residual (exact arithmetic)
    np.testing.assert_allclose(np.linalg.norm(A @ xt.numpy() - b), rt,
                               rtol=1e-6, atol=1e-12 * bt)


def test_fgmres_survives_breakdown():
    """b spans a 3-dimensional invariant subspace of A: Arnoldi breaks
    down at the third iteration of an 8-iteration cycle, leaving H rank
    deficient; the pseudo-inverse least squares still returns the exact
    solution, finite, in one cycle (as the reference's SVD lstsq)."""
    n = 40
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1.0, 3.0, n)
    A = (Q * lam) @ Q.T
    b = Q[:, :3] @ np.array([1.0, -2.0, 0.5])
    At = torch.tensor(A)
    xt, rt, bt = t_fgmres(lambda v: At @ v, torch.tensor(b), lambda v: v,
                          1e-12, 8, 3)
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(A @ xt.numpy(), b, atol=1e-11)
    xj, rj, _ = j_fgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                         lambda v: v, 1e-12, 8, 3)
    close(xt, xj, 1e-10)


def test_interop_round_trips():
    """numpy -> port -> numpy is exact for states, fields and bathymetry
    (a scalar depth stays a Python float)."""
    _, teq, _, state, _, fields = make("rect_land")
    back = state_to_numpy(state_from_numpy(state, "cpu", F64))
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    fb = fields_to_numpy(fields_from_numpy(fields, "cpu", F64))
    for k in fields:
        np.testing.assert_array_equal(fb[k], fields[k])
    assert bathymetry_from_numpy(50.0, "cpu", F64) == 50.0
    assert bathymetry_to_numpy(50.0) == 50.0
    np.testing.assert_array_equal(bathymetry_to_numpy(teq.bathymetry),
                                  np.asarray(teq.bathymetry))
    with pytest.raises(KeyError):
        state_from_numpy({"uv": state["uv"]}, "cpu", F64)
