"""2D tracers of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64, CPU),
from the same seeded numpy inputs: each term's residual of
``TracerEquation2D`` (two tracers, one per form) under every boundary key
of the tracer vocabulary, the conservative forms, Lax-Friedrichs, the
advective velocity factor and the wetting-and-drying depth; the CG1
equation with and without SUPG and its mass PCG; and the 2D vertex-based
limiter, inside and at boundaries, on one and on several components.

Tolerances: residuals and the PCG rtol 1e-12 with an atol of the same
factor times the array's scale (entries that cancel to ~0 differ in the
last bits between summation orders); the limiter 1e-13."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.equations.limiter import (  # noqa: E402
    VertexBasedP1DGLimiter as JLimiter)
from thetis_tpu.equations.shallowwater_2d import (  # noqa: E402
    DepthExpression as JDepth)
from thetis_tpu.equations.tracer_2d import (  # noqa: E402
    TracerEquation2D as JTracer, TracerEquation2DCG as JTracerCG)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu_torch.equations.limiter import (  # noqa: E402
    VertexBasedP1DGLimiter as TLimiter)
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    DepthExpression as TDepth)
from thetis_tpu_torch.equations.tracer_2d import (  # noqa: E402
    TracerEquation2D as TTracer, TracerEquation2DCG as TTracerCG)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS)
from thetis_tpu_torch.interop import (  # noqa: E402
    bathymetry_from_numpy, fields_from_numpy, fields_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LABELS = ("tracer_2d", "salt_2d")
TERMS = ("all", "HorizontalAdvectionTerm", "HorizontalDiffusionTerm",
         "SourceTerm")
#: every boundary key of the tracer vocabulary (ref tracer_eq_2d.py:78-115)
BCS = {
    "values": {1: {"value": 0.8},
               2: {"value-tracer_2d": 1.3, "value": 0.5},
               3: {"elev": 0.1, "value": 2.0},
               4: {"diff_flux": 0.01}},
    "flow": {1: {"elev": 0.3, "uv": np.array([0.1, -0.05]), "value": 1.2},
             2: {"un": -0.2, "value-salt_2d": 0.7},
             3: {"flux": -150.0, "value": 0.9},
             4: {"diff_flux": -0.02, "value": 1.0}},
    "land": {},
}


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def opts(conservative, lf, supg=False):
    return SimpleNamespace(
        tracer={"tracer_2d": SimpleNamespace(
                    use_conservative_form=conservative),
                "salt_2d": SimpleNamespace(use_conservative_form=False)},
        use_lax_friedrichs_tracer=lf, sipg_factor_tracer=1.5,
        use_supg_tracer=supg, horizontal_velocity_scale=0.3,
        horizontal_diffusivity_scale=2.0)


_MESH = {}


def meshes(kind="rect"):
    if kind not in _MESH:
        if kind == "rect":
            args = (6, 5, 1e4, 8e3)
            _MESH[kind] = (jgen.RectangleMesh(*args),
                           tgen.RectangleMesh(*args, device="cpu",
                                              dtype=F64))
        else:
            args = (6, 5, 1e4, 8e3)
            _MESH[kind] = (
                jgen.PeriodicRectangleMesh(*args, direction="both"),
                tgen.PeriodicRectangleMesh(*args, direction="both",
                                           device="cpu", dtype=F64))
    return _MESH[kind]


def inputs(cg=False, factor="scalar"):
    """Seeded bathymetry, tracer state and fields (the SWE state, two
    diffusivities, two sources, the LF and velocity factors)."""
    jm, _ = meshes()
    rng = np.random.default_rng(5)
    bathy = 15.0 + 5.0 * rng.random(jm.nv)
    shape = (jm.nv,) if cg else (jm.nc, 3)
    state = {l: 1.0 + 0.3 * rng.standard_normal(shape) for l in LABELS}
    fields = {
        "uv_2d": rng.normal(0, 0.3, (jm.nc, 3, 2)),
        "elev_2d": rng.normal(0, 0.2, (jm.nc, 3)),
        "lax_friedrichs_tracer_scaling_factor": 0.7,
        "diffusivity_h-tracer_2d": 2.0,
        "diffusivity_h-salt_2d": 1.0 + rng.random(jm.nv),
        "source-tracer_2d": rng.normal(0, 1e-3, (jm.nc, 3)),
        "source-salt_2d": 3e-4,
        "tracer_advective_velocity_factor": (
            0.8 if factor == "scalar"
            else 0.5 + rng.random((jm.nc, 3))),
    }
    return bathy, state, fields


def equations(bcs, conservative, lf, wd=False, cg=False, supg=False):
    jm, tm = meshes()
    bathy, _, _ = inputs(cg)
    o = opts(conservative, lf, supg)
    jd = JDepth(None, use_nonlinear_equations=True,
                use_wetting_and_drying=wd, wetting_and_drying_alpha=0.7)
    td = TDepth(use_nonlinear_equations=True, use_wetting_and_drying=wd,
                wetting_and_drying_alpha=0.7)
    jcls, tcls = (JTracerCG, TTracerCG) if cg else (JTracer, TTracer)
    jeq = jcls(jm, JAsm(jm, JFS(jm, "DG", 1)), o, jnp.asarray(bathy),
               list(LABELS), bnd_conditions=BCS[bcs], depth=jd)
    teq = tcls(tm, TAsm(tm, TFS(tm, "DG", 1)), o,
               bathymetry_from_numpy(bathy, "cpu", F64), list(LABELS),
               bnd_conditions=BCS[bcs], depth=td)
    return jeq, teq


def residuals(jeq, teq, term, bcs, state, fields):
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    jb = {m: {k: jnp.asarray(v) for k, v in spec.items()}
          for m, spec in BCS[bcs].items()}
    tb = {m: fields_from_numpy(spec, "cpu", F64)
          for m, spec in BCS[bcs].items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = fields_from_numpy(state, "cpu", F64)
    want = jeq.residual(term, js, js, jf, jf, jb)
    got = fields_to_numpy(teq.residual(term, ts, ts, tf, tf, tb))
    return got, want


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("bcs", sorted(BCS))
@pytest.mark.parametrize("form", ["nonconservative", "conservative"])
def test_residual_terms(term, bcs, form):
    jeq, teq = equations(bcs, form == "conservative", lf=False)
    _, state, fields = inputs()
    got, want = residuals(jeq, teq, term, bcs, state, fields)
    for l in LABELS:
        close(got[l], want[l], 1e-12)


@pytest.mark.parametrize("bcs", ["values", "flow"])
@pytest.mark.parametrize("form", ["nonconservative", "conservative"])
def test_lax_friedrichs_field_factor_and_wd_depth(bcs, form):
    """Lax-Friedrichs on, a DG advective-velocity factor and the
    wetting-and-drying depth in the conservative source and the flux
    boundary's area."""
    jeq, teq = equations(bcs, form == "conservative", lf=True, wd=True)
    _, state, fields = inputs(factor="field")
    got, want = residuals(jeq, teq, "all", bcs, state, fields)
    for l in LABELS:
        close(got[l], want[l], 1e-12)


def test_no_velocity_field():
    """Without ``uv_2d`` the advection term adds nothing; diffusion and
    sources remain."""
    jeq, teq = equations("values", False, lf=True)
    _, state, fields = inputs()
    fields = {k: v for k, v in fields.items() if k != "uv_2d"}
    got, want = residuals(jeq, teq, "all", "values", state, fields)
    for l in LABELS:
        close(got[l], want[l], 1e-12)


@pytest.mark.parametrize("supg", [False, True])
@pytest.mark.parametrize("bcs", ["values", "flow"])
def test_cg1_residual(supg, bcs):
    jeq, teq = equations(bcs, False, lf=False, cg=True, supg=supg)
    _, state, fields = inputs(cg=True)
    got, want = residuals(jeq, teq, "all", bcs, state, fields)
    for l in LABELS:
        close(got[l], want[l], 1e-12)


def test_cg1_mass_and_pcg():
    """The consistent CG1 mass and its lumped-Jacobi PCG inverse (25
    iterations, as the reference's ``lax.custom_linear_solve``)."""
    jeq, teq = equations("land", False, lf=False, cg=True)
    _, state, _ = inputs(cg=True)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = fields_from_numpy(state, "cpu", F64)
    m_want = jeq.mass_term(js)
    m_got = teq.mass_term(ts)
    inv_want = jeq.mass_inverse(m_want)
    inv_got = teq.mass_inverse(m_got)
    for l in LABELS:
        close(m_got[l], m_want[l], 1e-12)
        close(inv_got[l], inv_want[l], 1e-12)
        # the PCG inverts the mass it applies
        close(inv_got[l], state[l], 1e-10)


def test_dg_mass_pair():
    jeq, teq = equations("land", False, lf=False)
    _, state, _ = inputs()
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = fields_from_numpy(state, "cpu", F64)
    m_want, m_got = jeq.mass_term(js), teq.mass_term(ts)
    for l in LABELS:
        close(m_got[l], m_want[l], 1e-12)
        close(teq.mass_inverse(m_got)[l], jeq.mass_inverse(m_want)[l],
              1e-12)


def limiter_input(nc, k, rng):
    """A smooth slope plus noise: some cells limited, some not."""
    shape = (nc, 3) if k == 0 else (nc, 3, k)
    base = np.linspace(0.0, 1.0, nc)[:, None]
    base = base if k == 0 else base[..., None]
    return base + 0.2 * rng.standard_normal(shape)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_limiter(kind, k):
    """Boundaries (rect: the facet means enter the bounds) and none (the
    doubly periodic mesh); one component, and several limited each on
    its own."""
    jm, tm = meshes(kind)
    rng = np.random.default_rng(7 + k)
    u = limiter_input(jm.nc, k, rng)
    jl = JLimiter(JFS(jm, "DG", 1))
    tl = TLimiter(TFS(tm, "DG", 1))
    want = np.asarray(jl.apply(jnp.asarray(u)))
    got = tl.apply(torch.as_tensor(u)).numpy()
    close(got, want, 1e-13)
    # the limiter changes something and keeps the cell means
    assert np.abs(got - u).max() > 1e-3
    np.testing.assert_allclose(got.mean(axis=1), u.mean(axis=1), atol=1e-14)


def test_limiter_refuses_other_spaces():
    _, tm = meshes()
    with pytest.raises(ValueError, match="P1DG"):
        TLimiter(TFS(tm, "CG", 1))
