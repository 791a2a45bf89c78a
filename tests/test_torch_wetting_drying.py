"""Wetting-and-drying in ``thetis_tpu_torch`` against ``thetis_tpu`` (f64,
CPU), from the same seeded numpy inputs: the bathymetry displacement and
total depth, the SWE residual and displaced mass term with a scalar and a
P1 alpha (the displaced depth at ``elev``/``flux`` boundaries and in the
Riemann depth), the displacement Jacobian in the analytic ring blocks and
the hand-wired assembled CN that reaches it, the automatic alpha, and one
step of the Thacker parabolic bowl (``tests/test_thacker.py``, n = 10)
through ``FlowSolver2d`` under CrankNicolson, DIRK22 and BackwardEuler;
``slow``: the reference test's 12 h error bounds through the port.

Tolerances: residuals and mass 1e-12, blocks 1e-11 (as
``test_torch_swe.py``), the alpha field 1e-14, the model steps 1e-9 of
each field's max (as ``test_torch_flowsolver2d.py``'s implicit steps)."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.equations.shallowwater_2d import (  # noqa: E402
    DepthExpression as JDepth, ShallowWaterEquations as JSWE)
from thetis_tpu.equations.swe_blocks import (  # noqa: E402
    assemble_swe_blocks as j_blocks, swe_mass_blocks as j_mass_blocks)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JSolver  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
from thetis_tpu.timeintegration.steppers import (  # noqa: E402
    get_stepper as j_get_stepper)
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    DepthExpression as TDepth, ShallowWaterEquations as TSWE)
from thetis_tpu_torch.equations.swe_blocks import (  # noqa: E402
    assemble_swe_blocks as t_blocks, swe_mass_blocks as t_mass_blocks)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS)
from thetis_tpu_torch.interop import (  # noqa: E402
    bathymetry_from_numpy, fields_from_numpy, flowsolver2d_from_reference,
    state_from_numpy, state_to_numpy, wd_alpha_from_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402
from thetis_tpu_torch.solvers.newton import (  # noqa: E402
    NewtonParameters as TNP)
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    get_stepper as t_get_stepper)

F64 = torch.float64
#: open boundaries whose external depth is displaced (elev, flux), land
BCS = {1: {"elev": 0.3}, 3: {"flux": -150.0}, 2: {"un": 0.1}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("alpha", ["scalar", "array"])
@pytest.mark.parametrize("nonlinear", [True, False])
def test_displacement_and_total_depth(alpha, nonlinear):
    """Wet, dry and near-dry points (h from -3 to 3 m)."""
    rng = np.random.default_rng(2)
    bathy = rng.uniform(-2.0, 2.0, (40, 6))
    eta = rng.uniform(-1.0, 1.0, (40, 6))
    a = 0.4 if alpha == "scalar" else rng.uniform(0.1, 2.0, (40, 6))
    jd = JDepth(None, use_nonlinear_equations=nonlinear,
                use_wetting_and_drying=True, wetting_and_drying_alpha=0.5)
    td = TDepth(use_nonlinear_equations=nonlinear,
                use_wetting_and_drying=True, wetting_and_drying_alpha=0.5)
    ta = a if alpha == "scalar" else torch.as_tensor(a)
    for fn in ("wd_displacement", "total_depth"):
        want = getattr(jd, fn)(jnp.asarray(bathy), jnp.asarray(eta),
                               jnp.asarray(a))
        got = getattr(td, fn)(torch.as_tensor(bathy), torch.as_tensor(eta),
                              ta)
        close(got, want, 1e-14)
    # the default alpha, and no displacement without wetting-and-drying
    close(td.wd_displacement(torch.as_tensor(bathy), torch.as_tensor(eta)),
          jd.wd_displacement(jnp.asarray(bathy), jnp.asarray(eta)), 1e-14)
    td.use_wetting_and_drying = False
    assert not td.wd_displacement(torch.as_tensor(bathy),
                                  torch.as_tensor(eta)).any()


def wd_opts(alpha):
    return SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=True,
        wetting_and_drying_alpha=alpha, use_lax_friedrichs_velocity=True,
        use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)


_CACHE = {}


def make(alpha):
    """Both SWE equations on a 6x5 rectangle whose bed rises above the
    still water on one side (dry cells), with ``alpha`` a scalar or a P1
    field."""
    if alpha in _CACHE:
        return _CACHE[alpha]
    jm = jgen.RectangleMesh(6, 5, 1e4, 8e3)
    tm = tgen.RectangleMesh(6, 5, 1e4, 8e3, device="cpu", dtype=F64)
    rng = np.random.default_rng(4)
    bathy = 3.0 - 6.0 * jm.coords_np[:, 0] / 1e4 + 0.3 * rng.random(jm.nv)
    a = 0.6 if alpha == "scalar" else 0.2 + rng.random(jm.nv)
    ja = a if alpha == "scalar" else jnp.asarray(a)
    jeq = JSWE(jm, JAsm(jm, JFS(jm, "DG", 1)), wd_opts(ja),
               jnp.asarray(bathy), bnd_conditions=BCS)
    teq = TSWE(tm, TAsm(tm, TFS(tm, "DG", 1)),
               wd_opts(wd_alpha_from_numpy(a, tm)),
               bathymetry_from_numpy(bathy, "cpu", F64), bnd_conditions=BCS)
    state = {"uv": rng.normal(0, 0.3, (jm.nc, 3, 2)),
             "elev": rng.normal(0, 0.4, (jm.nc, 3))}
    lagged = {"uv": rng.normal(0, 0.3, (jm.nc, 3, 2)),
              "elev": rng.normal(0, 0.4, (jm.nc, 3))}
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0,
              "quadratic_drag_coefficient": 2.5e-3, "viscosity_h": 2.0}
    _CACHE[alpha] = (jeq, teq, state, lagged, fields)
    return _CACHE[alpha]


def jstate(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def tstate(d):
    return state_from_numpy(d, "cpu", F64)


@pytest.mark.parametrize("alpha", ["scalar", "field"])
@pytest.mark.parametrize("label", ["all", "implicit"])
def test_residual(alpha, label):
    jeq, teq, state, lagged, fields = make(alpha)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    want = jeq.residual(label, jstate(state), jstate(lagged), jf, jf, BCS)
    got = state_to_numpy(teq.residual(label, tstate(state), tstate(lagged),
                                      tf, tf, BCS))
    for k in ("uv", "elev"):
        close(got[k], want[k], 1e-12)


@pytest.mark.parametrize("alpha", ["scalar", "field"])
def test_mass_term(alpha):
    """The displaced mass; ``mass_inverse`` stays the exact DG inverse."""
    jeq, teq, state, _, _ = make(alpha)
    for meth in ("mass_term", "mass_inverse"):
        want = getattr(jeq, meth)(jstate(state))
        got = getattr(teq, meth)(tstate(state))
        for k in ("uv", "elev"):
            close(got[k], want[k], 1e-12)
    # the displacement is in the continuity row only
    m = teq.mass_term(tstate(state))["elev"]
    plain = teq.asm.mass_apply(tstate(state)["elev"])
    assert float((m - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("alpha", ["scalar", "field"])
def test_mass_blocks_and_assembled_blocks(alpha):
    """The displacement Jacobian on the continuity rows of the mass
    blocks, and in the analytic ring blocks of ``M - c dR/du``."""
    jeq, teq, _, lagged, fields = make(alpha)
    close(t_mass_blocks(teq, tstate(lagged), F64),
          j_mass_blocks(jeq, jstate(lagged), jnp.float64, layout="T"), 1e-12)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    A_j = j_blocks(jeq, jstate(lagged), jf, BCS, 25.0, layout="T")
    A_t = t_blocks(teq, tstate(lagged), tf, BCS, 25.0)
    close(A_t, A_j, 1e-11)


PARAMS = dict(ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=50)


@pytest.mark.parametrize("path", ["analytic", "probing"])
def test_hand_wired_assembled_cn(path):
    """``FlowSolver2d`` keeps wetting-and-drying off the assembled path
    (``_assembled_eligible``), but a CN built by hand with
    ``assembled_solve`` reaches it: the analytic blocks (with the
    displacement Jacobian of ``swe_mass_blocks``) without a Picard state,
    colour probing with one."""
    jeq, teq, state, lagged, fields = make("field")
    dt = 30.0
    jst = j_get_stepper("CrankNicolson", jeq, dt, semi_implicit=True,
                        assembled_solve=True,
                        solver_parameters=JNP(**PARAMS))
    tst = t_get_stepper("CrankNicolson", teq, dt, semi_implicit=True,
                        assembled_solve=True,
                        solver_parameters=TNP(**PARAMS))
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    kw_j, kw_t = {}, {}
    if path == "probing":
        kw_j = {"linearization_state": jstate(lagged)}
        kw_t = {"linearization_state": tstate(lagged)}
    want = jst.advance(0.0, jstate(state), jf, jf, BCS, **kw_j)
    got = state_to_numpy(tst.advance(0.0, tstate(state), tf, tf, BCS,
                                     **kw_t))
    for k in ("uv", "elev"):
        close(got[k], want[k], 1e-9)
    assert tst.stats["ksp_rel_residual"] < 1e-10


# --------------------------------------------------------------- Thacker
L_MESH = 951646.46
D0, L_BOWL, ETA0 = 50.0, 430620.0, 2.0
A_BOWL = ((D0 + ETA0) ** 2 - D0**2) / ((D0 + ETA0) ** 2 + D0**2)


def bowl(x, y):
    """The bowl's bathymetry and its initial (= after one period)
    elevation (the reference test's setup)."""
    X0 = L_MESH / 2
    r2 = (x - X0) ** 2 + (y - X0) ** 2
    b = D0 * (1 - r2 / L_BOWL**2)
    eta = D0 * (np.sqrt(1 - A_BOWL**2) / (1 - A_BOWL) - 1
                - r2 * ((1 + A_BOWL) / (1 - A_BOWL) - 1) / L_BOWL**2)
    return b, eta


def thacker_options(o, stepper, dt, t_end):
    o.timestep = dt
    o.simulation_end_time = t_end
    o.simulation_export_time = min(3600.0, t_end)
    o.no_exports = True
    o.swe_timestepper_type = stepper
    o.use_wetting_and_drying = True
    o.use_automatic_wetting_and_drying_alpha = True


def thacker_reference(stepper, n=10, dt=600.0, t_end=600.0):
    """The reference's bowl with a Krylov budget that solves the step
    systems to roundoff: under wetting-and-drying the mass inverse is
    only a preconditioner, and with the default budget (48 iterations to
    1e-7) the DIRK22 stages stop near 8e-5, where the two packages'
    Krylov paths part at 6e-6 of the state (to 4e-9 at 1e-7, 8e-13 at
    1e-12 when converged)."""
    jm = jgen.SquareMesh(n, n, L_MESH)
    b, eta = bowl(jm.coords_np[:, 0], jm.coords_np[:, 1])
    s = JSolver(jm, jnp.asarray(b))
    thacker_options(s.options, stepper, dt, t_end)
    s.options.swe_timestepper_options.solver_parameters = JNP(**PARAMS)
    s.assign_initial_conditions(elev=jnp.asarray(eta))
    return s


def test_automatic_alpha():
    """``set_wetting_and_drying_alpha`` on the bowl: per-cell |L grad h|
    capped to [alpha_min, alpha_max], the vertex maximum, as a P1 field."""
    ref = thacker_reference("CrankNicolson")
    port = flowsolver2d_from_reference(
        ref, tgen.SquareMesh(10, 10, L_MESH, device="cpu", dtype=F64))
    a_ref = ref.options.wetting_and_drying_alpha
    a_port = port.options.wetting_and_drying_alpha
    assert a_port.function_space.family == "CG"
    close(a_port.data, a_ref.data, 1e-14)
    assert float(a_port.data.min()) < float(a_port.data.max()) <= 10.0
    for lo, hi in ((None, 2.0), (1.5, None)):
        for s in (ref, port):
            o = s.options
            o.wetting_and_drying_alpha_min = lo
            o.wetting_and_drying_alpha_max = hi
            s.set_wetting_and_drying_alpha()
        close(port.options.wetting_and_drying_alpha.data,
              ref.options.wetting_and_drying_alpha.data, 1e-14)


def test_constant_alpha_reaches_the_equation():
    _, tm = jgen.SquareMesh(4, 4, 1e3), tgen.SquareMesh(
        4, 4, 1e3, device="cpu", dtype=F64)
    s = FlowSolver2d(tm, 2.0)
    s.options.no_exports = True
    s.options.timestep = 1.0
    s.options.use_wetting_and_drying = True
    s.options.wetting_and_drying_alpha = 0.3
    s.initialize()
    assert s.eq_sw.alpha_q == 0.3 and s.eq_sw.depth.alpha == 0.3
    assert s.timestepper.preconditioner == "mass"
    assert not s.timestepper.assembled_solve


@pytest.fixture(scope="module")
def thacker_steps():
    """One 600 s step of each stepper in both packages."""
    out = {}
    for stepper in ("CrankNicolson", "DIRK22", "BackwardEuler"):
        ref = thacker_reference(stepper)
        port = flowsolver2d_from_reference(
            ref, tgen.SquareMesh(10, 10, L_MESH, device="cpu", dtype=F64))
        x0 = port.fields.elev_2d.data.clone()
        ref.iterate()
        port.iterate()
        out[stepper] = (ref, port, x0)
    return out


@pytest.mark.parametrize("stepper", ["CrankNicolson", "DIRK22",
                                     "BackwardEuler"])
def test_thacker_step_matches_reference(thacker_steps, stepper):
    ref, port, x0 = thacker_steps[stepper]
    assert type(port.timestepper).__name__ == type(ref.timestepper).__name__
    assert port.iteration == ref.iteration == 1
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-9)
    assert float((port.fields.elev_2d.data - x0).abs().max()) > 1e-3
    # the semi-implicit solves: one linear solve per implicit stage
    st = port.timestepper.stats
    assert st["newton_iterations"] == (2 if stepper == "DIRK22" else 1)
    assert st["ksp_cycles"] >= 1 and st["ksp_rel_residual"] < 1e-11


def thacker_error(s):
    """The reference test's masked L2 elevation error over the mesh
    length."""
    xy = s.function_spaces.H_2d.dof_coords().numpy()
    _, correct = bowl(xy[..., 0], xy[..., 1])
    r = np.hypot(xy[..., 0] - L_MESH / 2, xy[..., 1] - L_MESH / 2)
    mask = 0.5 * (1 - np.tanh((r - 420000.0) / 1000.0))
    diff = torch.as_tensor(mask * (s.fields.elev_2d.data.numpy() - correct))
    return float(s.asm.norm_l2(diff)) / L_MESH


@pytest.mark.slow
@pytest.mark.parametrize("stepper,max_err", [
    ("CrankNicolson", 0.26), ("DIRK22", 0.26), ("BackwardEuler", 0.33)])
def test_thacker_12h_error_bounds(stepper, max_err):
    """``tests/test_thacker.py`` through the port: one period (12 h, 72
    steps of 600 s) on the 10x10 mesh, the reference's bounds."""
    tm = tgen.SquareMesh(10, 10, L_MESH, device="cpu", dtype=F64)
    b, eta = bowl(tm.coords_np[:, 0], tm.coords_np[:, 1])
    s = FlowSolver2d(tm, torch.as_tensor(b))
    thacker_options(s.options, stepper, 600.0, 43200.0)
    s.assign_initial_conditions(elev=torch.as_tensor(eta))
    s.iterate()
    assert s.iteration == 72
    err = thacker_error(s)
    assert np.isfinite(err) and err < max_err, err
