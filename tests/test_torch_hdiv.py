"""The H(div) families of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64,
CPU): the RT1, BDM1, RT2 and BDM2 spaces (``fem/{rt,bdm,rt2,bdm2}.py``),
the RT1/BDM1 x P0 and RT2/BDM2 x P1DG shallow-water equations
(``equations/shallowwater_{rtdg,rt2}.py``) and ``FlowSolver2d``'s rt-dg
and bdm-dg branches.

Both packages get the same numpy-seeded inputs on small rectangles (6x5
and 8x4; every boundary marker in use: an open ``elev`` boundary, a
``flux`` inflow, a ``uv`` inflow, a land wall).  Tolerances: the spaces'
tables, evaluation, projections (the facet-dof scatters), mass apply and
the fixed-iteration PCG mass inverse 1e-12 of scale; every residual term
1e-12 of its largest entry; one and three model steps through
``iterate()`` 1e-10 of each field's max.  The reference tests' own cases
run through the port in ``test_torch_hdiv_cases.py``."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402
import thetis_tpu as J  # noqa: E402
from thetis_tpu.equations.shallowwater_rt2 import (  # noqa: E402
    ShallowWaterEquationsRT2DG as JRT2DG)
from thetis_tpu.equations.shallowwater_rtdg import (  # noqa: E402
    ShallowWaterEquationsRTDG as JRTDG)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.bdm import BDMSpace as JBDM  # noqa: E402
from thetis_tpu.fem.bdm2 import BDM2Space as JBDM2  # noqa: E402
from thetis_tpu.fem.rt import RTSpace as JRT  # noqa: E402
from thetis_tpu.fem.rt2 import RT2Space as JRT2  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_rt2 import (  # noqa: E402
    ShallowWaterEquationsRT2DG as TRT2DG)
from thetis_tpu_torch.equations.shallowwater_rtdg import (  # noqa: E402
    ShallowWaterEquationsRTDG as TRTDG)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.bdm import BDMSpace as TBDM  # noqa: E402
from thetis_tpu_torch.fem.bdm2 import BDM2Space as TBDM2  # noqa: E402
from thetis_tpu_torch.fem.rt import RTSpace as TRT  # noqa: E402
from thetis_tpu_torch.fem.rt2 import RT2Space as TRT2  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
TIGHT = dict(ksp_rtol=1e-12, ksp_max_it=240, gmres_restart=40)
#: kind -> (reference space, port space, P1DG quadrature degree, equation
#: classes)
SPACES = {"rt": (JRT, TRT, None, JRTDG, TRTDG),
          "bdm": (JBDM, TBDM, None, JRTDG, TRTDG),
          "rt2": (JRT2, TRT2, 5, JRT2DG, TRT2DG),
          "bdm2": (JBDM2, TBDM2, 5, JRT2DG, TRT2DG)}
KINDS = sorted(SPACES)


def tensor(v):
    return torch.as_tensor(np.array(v), dtype=F64)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def space_pair(kind, nx=6, ny=5, lx=3.0, ly=2.0):
    jcls, tcls, qd, _, _ = SPACES[kind]
    jm = J.RectangleMesh(nx, ny, lx, ly)
    tm = T.RectangleMesh(nx, ny, lx, ly, device="cpu")
    kw = {} if qd is None else {"quad_degree": qd}
    ja = JAsm(jm, J.FunctionSpace(jm, "DG", 1, **kw))
    ta = TAsm(tm, T.FunctionSpace(tm, "DG", 1, **kw))
    return jcls(jm, ja), tcls(tm, ta)


@pytest.fixture(scope="module")
def spaces():
    return {k: space_pair(k) for k in KINDS}


def dofs_np(sp, rng):
    return rng.standard_normal(tuple(sp.dof_shape()))


TABLES = {"rt": ("psi_q", "psi_tr", "div", "gradfac", "Mloc", "mass_diag",
                 "wdetJ", "wlen"),
          "bdm": ("psi_q", "psi_tr", "div", "grad", "Mloc",
                  ("mass_diag", "_diag"), "wdetJ", "wlen", "_own_trace"),
          "rt2": ("psi_q", "div_q", "grad_q", "psi_tr", "Mloc", "mass_diag",
                  "wdetJ", "wlen"),
          "bdm2": ("psi_q", "div_q", "grad_q", "psi_tr", "Mloc",
                   "mass_diag", "wdetJ", "wlen")}


@pytest.mark.parametrize("kind", KINDS)
def test_space_tables_match_reference(spaces, kind):
    js, ts = spaces[kind]
    assert (ts.family, ts.degree, ts.ndofs) == (js.family, js.degree,
                                                js.ndofs)
    assert tuple(ts.dof_shape()) == tuple(js.dof_shape())
    for name in TABLES[kind]:
        tname, jname = name if isinstance(name, tuple) else (name, name)
        close(getattr(ts, tname), getattr(js, jname), 1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_evaluation_matches_reference(spaces, kind):
    js, ts = spaces[kind]
    U = dofs_np(ts, np.random.default_rng(1))
    names = ["cell_values", "facet_traces", "facet_un_quad",
             "cell_div_q" if kind.endswith("2") else "cell_div"]
    if not kind.endswith("2"):
        names.append("facet_un_mean")
    for name in names:
        close(getattr(ts, name)(tensor(U)), getattr(js, name)(
            jnp.asarray(U)), 1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_projections_match_reference(spaces, kind):
    """The facet-dof scatters of every integrand kind."""
    js, ts = spaces[kind]
    rng = np.random.default_rng(2)
    nc, nf = ts.mesh.nc, ts.mesh.nf
    nq, nqf = ts.wdetJ.shape[1], ts.wlen.shape[1]
    args = {"cell_to_dofs": (nc, nq, 2), "div_to_dofs": (nc, nq),
            "grad_to_dofs": (nc, nq, 2, 2), "facet_to_dofs": (nf, 2, nqf, 2),
            "bnd_normal_to_dofs": (nf, nqf)}
    for name, shape in args.items():
        x = rng.standard_normal(shape)
        close(getattr(ts, name)(tensor(x)), getattr(js, name)(
            jnp.asarray(x)), 1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_mass_matches_reference(spaces, kind):
    """The mass and its fixed-iteration Jacobi PCG inverse (30, 40, 40
    and 50 iterations for RT1, BDM1, RT2 and BDM2)."""
    js, ts = spaces[kind]
    U = dofs_np(ts, np.random.default_rng(3))
    close(ts.mass_apply(tensor(U)), js.mass_apply(jnp.asarray(U)), 1e-12)
    r = np.asarray(js.mass_apply(jnp.asarray(U)))
    got = ts.mass_inverse(tensor(r))
    close(got, js.mass_inverse(jnp.asarray(r)), 1e-12)
    close(got, U, 1e-8)  # the PCG converges on these masses


def project_inputs(kind, mesh):
    """Each ``project_vector`` input form of the reference's (numpy)."""
    rng = np.random.default_rng(4)
    nv, nf = mesh.nv, mesh.nf
    if kind in ("rt", "bdm"):
        out = {"constant": np.array([0.3, -0.2]),
               "cg1": rng.standard_normal((nv, 2)),
               "dofs": rng.standard_normal((nf, 2))}
        if kind == "rt":
            out["facet_vectors"] = out.pop("dofs")
            out["dofs"] = rng.standard_normal(nf)
        return out
    out = {"callable": lambda x, y: np.stack(
        [0.3 + x - 2 * y + 0.1 * x * y, 1.0 + 0.5 * x * x + y], axis=-1)}
    if kind == "bdm2":
        out["constant"] = np.array([0.3, -0.2])
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_project_vector_matches_reference(spaces, kind):
    js, ts = spaces[kind]
    for form, v in project_inputs(kind, ts.mesh).items():
        want = js.project_vector(v if callable(v) else jnp.asarray(v))
        got = ts.project_vector(v if callable(v) else tensor(v))
        close(got, want, 1e-12)


def test_rt2_constant_vector():
    """A constant vector onto RT2: both facet dofs u . n and the cell
    means u, as the nodal interpolation of the constant field gives them.
    (The reference's constant branch sums the normal product over a
    singleton axis, ``rt2.py:261-265``, and returns nf + 2 nc values
    instead of 2 nf + 2 nc: ROADMAP C.)"""
    js, ts = space_pair("rt2")
    v = np.array([0.3, -0.2])
    got = ts.project_vector(tensor(v))
    close(got, ts.project_vector(lambda x, y: np.stack(
        [np.full(np.shape(x), v[0]), np.full(np.shape(x), v[1])], -1)),
        1e-15)
    assert js.project_vector(jnp.asarray(v)).shape != (js.ndofs,)


# -- the equations --------------------------------------------------------
def eq_options(nonlin=True):
    return SimpleNamespace(use_nonlinear_equations=nonlin,
                           use_wetting_and_drying=False)


BND = {1: {"elev": 0.05}, 2: {"flux": -40.0}, 3: {"uv": (0.1, 0.05)}}
LX, LY = 4e3, 2e3


@pytest.fixture(scope="module")
def eqs():
    """kind -> (reference, port) equations on 8x4 over 4 x 2 km with a
    sloped CG1 bed and open boundaries on markers 1-3."""
    out = {}
    for kind in KINDS:
        js, ts = space_pair(kind, 8, 4, LX, LY)
        jcls, tcls = SPACES[kind][3:]
        bathy = 20.0 + 5.0 * js.mesh.coords_np[:, 0] / LX
        out[kind] = (
            jcls(js.mesh, js.asm, js, eq_options(), jnp.asarray(bathy),
                 bnd_conditions=BND),
            tcls(ts.mesh, ts.asm, ts, eq_options(), tensor(bathy),
                 bnd_conditions=BND))
    return out


def eq_inputs(eq, seed=5, manning=False):
    rng = np.random.default_rng(seed)
    mesh, nv = eq.mesh, eq.mesh.nv
    x = mesh.coords_np
    shape = tuple(eq.rt.dof_shape())
    eshape = (mesh.nc, 1) if isinstance(eq, TRTDG) else (mesh.nc, 3)
    state = {"uv": 0.2 * rng.standard_normal(shape),
             "elev": 0.1 * rng.standard_normal(eshape)}
    old = {"uv": 0.2 * rng.standard_normal(shape),
           "elev": 0.1 * rng.standard_normal(eshape)}
    fields = {"coriolis": 1e-4 + 1e-5 * x[:, 1] / LY,
              "linear_drag_coefficient": 1e-4,
              "momentum_source": 1e-3 * rng.standard_normal((nv, 2)),
              "volume_source": 1e-4 * rng.random(nv)}
    if manning:
        fields["manning_drag_coefficient"] = 0.02 + 0.01 * rng.random(nv)
    else:
        fields["quadratic_drag_coefficient"] = 2.5e-3
    bnd = {1: {"elev": 0.05}, 2: {"flux": -40.0},
           3: {"uv": np.array([0.1, 0.05])}}
    return state, old, fields, bnd


def conv(a, arr):
    if isinstance(a, dict):
        return {k: conv(v, arr) for k, v in a.items()}
    return arr(a)


TERMS = ["ExternalPressureGradientTerm", "HUDivTerm",
         "HorizontalAdvectionTerm", "CoriolisTerm", "QuadraticDragTerm",
         "ManningDrag", "LinearDragTerm", "MomentumSourceTerm",
         "ContinuitySourceTerm", "all"]


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("kind", KINDS)
def test_residual_term_matches_reference(eqs, kind, term):
    je, te = eqs[kind]
    assert [n for n, _, _ in te.terms] == [n for n, _, _ in je.terms]
    manning = term == "ManningDrag"
    state, old, fields, bnd = eq_inputs(te, manning=manning)
    label = ("all" if term == "all" else
             ["QuadraticDragTerm"] if manning else [term])
    out = []
    for e, arr in ((je, jnp.asarray), (te, tensor)):
        f = conv(fields, arr)
        out.append(e.residual(label, conv(state, arr), conv(old, arr), f, f,
                              conv(bnd, arr)))
    moved = False
    for k in ("uv", "elev"):
        if np.abs(np.asarray(out[0][k])).max() > 0:
            moved = True
            close(out[1][k], out[0][k], 1e-12)
        else:
            assert float(out[1][k].abs().max()) == 0.0
    assert moved


@pytest.mark.parametrize("kind", KINDS)
def test_mass_and_norms_match_reference(eqs, kind):
    je, te = eqs[kind]
    state = eq_inputs(te)[0]
    for name in ("mass_term", "mass_inverse"):
        a = getattr(je, name)(conv(state, jnp.asarray))
        b = getattr(te, name)(conv(state, tensor))
        for k in ("uv", "elev"):
            close(b[k], a[k], 1e-12)
    for name, k in (("norm_elev", "elev"), ("norm_uv", "uv")):
        a = float(getattr(je, name)(jnp.asarray(state[k])))
        b = float(getattr(te, name)(tensor(state[k])))
        assert abs(b - a) <= 1e-12 * abs(a)


def test_wetting_and_drying_is_refused():
    _, ts = space_pair("rt")
    o = eq_options()
    o.use_wetting_and_drying = True
    with pytest.raises(ValueError, match="dg-dg"):
        TRTDG(ts.mesh, ts.asm, ts, o, 10.0)


# -- the model: FlowSolver2d's rt-dg and bdm-dg branches ----------------------
CONFIGS = {"rt-dg p0": ("rt-dg", 0, True), "bdm-dg p0": ("bdm-dg", 0, True),
           "rt-dg p1": ("rt-dg", 1, True), "bdm-dg p1": ("bdm-dg", 1, True),
           "rt-dg p0 newton": ("rt-dg", 0, False)}


def reference_solver(config, nsteps):
    """A seiche on 10x2 (5 x 1 km, a sloped bed, depth 100 m), dt 10 s,
    an open ``elev`` boundary on marker 2, Coriolis and quadratic drag,
    the CN (semi-implicit or Newton) solved to roundoff; initialized."""
    family, p, semi = CONFIGS[config]
    jm = J.RectangleMesh(10, 2, 5e3, 1e3)
    p1 = J.FunctionSpace(jm, "CG", 1)
    so = J.solver2d.FlowSolver2d(
        jm, J.Function(p1).interpolate(lambda x, y: 100.0 - 0.002 * x))
    o = so.options
    o.element_family = family
    o.polynomial_degree = p
    o.timestep = 10.0
    o.simulation_export_time = 10.0
    o.simulation_end_time = 10.0 * nsteps
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = semi
    o.swe_timestepper_options.solver_parameters = JNP(**TIGHT)
    # vertex fields, not Constants: the reference's p = 0 equations call
    # float() on a scalar coefficient, which fails under its jit (ROADMAP
    # C)
    ones = np.ones(jm.nv)
    o.coriolis_frequency = J.Function(p1).assign(1e-4 * ones)
    o.quadratic_drag_coefficient = J.Function(p1).assign(2.5e-3 * ones)
    so.bnd_functions["shallow_water"] = {
        2: {"elev": J.Function(p1).assign(0.01 * ones)}}
    so.create_function_spaces()
    if p == 0:
        mids = jm.cell_midpoints()
        elev = jnp.asarray(0.5 * np.cos(np.pi * mids[:, 0] / 5e3))[:, None]
    else:
        elev = J.Function(so.function_spaces.H_2d).interpolate(
            lambda x, y: 0.5 * np.cos(np.pi * x / 5e3))
    so.assign_initial_conditions(elev=elev)
    return so


def run_states(s):
    out = []
    s.iterate(export_func=lambda: out.append(
        {k: np.array(v) for k, v in s._get_state().items()}))
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hdiv_steps_match_reference(config):
    """Steps 1 and 3 of the same run in both packages; the volume."""
    ref = reference_solver(config, 3)
    port = flowsolver2d_from_reference(
        ref, T.RectangleMesh(10, 2, 5e3, 1e3, device="cpu"))
    assert type(port.function_spaces.U_2d).__name__ == type(
        ref.function_spaces.U_2d).__name__
    want, got = run_states(ref), run_states(port)
    assert len(want) == len(got) == 3
    for i in (0, 2):
        for k, v in want[i].items():
            close(got[i][k], v, 1e-10)
    assert np.abs(want[2]["uv"]).max() > 1e-3
    if CONFIGS[config][1] == 0:  # the reference's volume reads bathy_c
        assert port.compute_volume_2d() == pytest.approx(
            ref.compute_volume_2d(), rel=1e-12)


def test_hdiv_plain_swe_only():
    """The reference's restrictions (``solver2d.py:303-311``): no
    tracers, sediment, NH or farms with an H(div) family."""
    mesh = T.RectangleMesh(4, 2, 1e3, 1e3, device="cpu")
    s = T.FlowSolver2d(mesh, 10.0)
    s.options.element_family = "rt-dg"
    s.options.add_tracer_2d("tracer_2d")
    s.options.timestep = 1.0
    s.options.no_exports = True
    with pytest.raises(ValueError, match="plain shallow-water"):
        s.initialize()
