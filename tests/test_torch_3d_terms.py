"""The 3D step's modules, one by one, ``thetis_tpu_torch`` against
``thetis_tpu`` on small meshes with a sloped bed and a non-zero free
surface, fed the same numpy fields (f64, CPU): the EOS (linear and
Jackett), the weak and pointwise vertical velocity, the baroclinic head
and internal pressure gradient, every term of ``MomentumEquation3D`` and
``TracerEquation3D``, the implicit vertical viscosity with law-of-wall
drag and wind stress, ``vdiff_implicit``, the prism vertex limiter, and
one ``ModeSplit2DEquations`` CrankNicolson step with a momentum source.

Tolerances: rtol 1e-12 (atol 1e-12 x the output's scale) for every
pointwise or assembled quantity (the same algebra, summed in other
orders); rtol 1e-8 for the CN step, whose Krylov solve amplifies
roundoff (as in ``test_torch_cn_slice.py``); a uniform field through the
limiter within 1e-15 (the element mean's roundoff)."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.mesh.extruded import ExtrudedMesh as JExt  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.assembly3d import Assembler3D as JA3  # noqa: E402
from thetis_tpu.equations import eos as jeos  # noqa: E402
from thetis_tpu.equations import utility3d as ju3  # noqa: E402
from thetis_tpu.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D as JMom, vertical_viscosity_implicit as j_vvi)
from thetis_tpu.equations.tracer_3d import TracerEquation3D as JTr  # noqa: E402
from thetis_tpu.equations.turbulence import (  # noqa: E402
    GenericLengthScaleModel as JGLS)
from thetis_tpu.equations.limiter import (  # noqa: E402
    VertexBasedP1DGLimiter3D as JLim)
from thetis_tpu.equations.shallowwater_2d import (  # noqa: E402
    ModeSplit2DEquations as JMS)
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
from thetis_tpu.timeintegration.steppers import (  # noqa: E402
    CrankNicolson as JCN)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh as TExt  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.assembly3d import Assembler3D as TA3  # noqa: E402
from thetis_tpu_torch.equations import eos as teos  # noqa: E402
from thetis_tpu_torch.equations import utility3d as tu3  # noqa: E402
from thetis_tpu_torch.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D as TMom, vertical_viscosity_implicit as t_vvi)
from thetis_tpu_torch.equations.tracer_3d import (  # noqa: E402
    TracerEquation3D as TTr)
from thetis_tpu_torch.equations.turbulence import (  # noqa: E402
    GenericLengthScaleModel as TGLS, vdiff_implicit)
from thetis_tpu_torch.equations.limiter import (  # noqa: E402
    VertexBasedP1DGLimiter3D as TLim)
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ModeSplit2DEquations as TMS)
from thetis_tpu_torch.solvers.newton import NewtonParameters as TNP  # noqa: E402
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    CrankNicolson as TCN)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LX, LY, NZ = 1e3, 8e2, 3
MESHES = {
    "periodic": lambda g, **kw: g.PeriodicRectangleMesh(
        5, 4, LX, LY, direction="x", **kw),
    "rect": lambda g, **kw: g.RectangleMesh(4, 3, LX, LY, **kw),
}
MOM_TERMS = ["PressureGradientTerm", "HorizontalAdvectionTerm",
             "VerticalAdvectionTerm", "CoriolisTerm",
             "HorizontalViscosityTerm", "SourceTerm"]
TR_TERMS = ["HorizontalAdvectionTerm", "VerticalAdvectionTerm",
            "HorizontalDiffusionTerm", "VerticalDiffusionTerm", "SourceTerm"]


def opts():
    """The options the 3D terms and the 2D mode read (the model options'
    defaults)."""
    return SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_lax_friedrichs_tracer=False,
        use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        sipg_factor_tracer=1.0, norm_smoother=0.0)


class Case:
    """Both packages' 3D assemblers on one mesh, a sloped bed, a wavy
    free surface, and a seeded numpy generator for the fields."""

    def __init__(self, kind):
        jm = MESHES[kind](jgen)
        tm = MESHES[kind](tgen, device="cpu", dtype=F64)
        self.jm, self.tm = jm, tm
        self.ja = JA3(jm, JAsm(jm, JFS(jm, "DG", 1)), JExt(jm, NZ))
        self.ta = TA3(tm, TAsm(tm, TFS(tm, "DG", 1)), TExt(tm, NZ))
        xy = jm.coords_np
        self.bathy = (20.0 + 30.0 * xy[:, 1] / LY + 5.0 * np.sin(
            2 * np.pi * xy[:, 0] / LX))[jm.cells_np]
        self.elev = (0.5 * np.cos(2 * np.pi * xy[:, 0] / LX)
                     * (xy[:, 1] / LY))[jm.cells_np]
        self.jg = self.ja.layer_geometry(self.ja.ext.z_interfaces(
            jnp.asarray(self.bathy), jnp.asarray(self.elev)))
        self.tg = self.ta.layer_geometry(self.ta.ext.z_interfaces(
            torch.tensor(self.bathy), torch.tensor(self.elev)))
        self.rng = np.random.default_rng(42)
        self.nc = jm.nc

    def rand(self, *shape, scale=1.0):
        return scale * self.rng.standard_normal(shape)


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request):
    return Case(request.param)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def jt(d):
    """numpy dict -> (jax dict, torch dict); Python scalars stay."""
    def j(v):
        return v if np.isscalar(v) else jnp.asarray(v)

    def t(v):
        return v if np.isscalar(v) else torch.tensor(v)

    return ({k: j(v) for k, v in d.items()}, {k: t(v) for k, v in d.items()})


# -- EOS ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["linear", "jackett"])
def test_equation_of_state(kind):
    rng = np.random.default_rng(1)
    s = 30.0 + 8.0 * rng.random((50, 3))
    s[0, 0] = -1.0  # negative salinity is clipped
    th = -2.0 + 30.0 * rng.random((50, 3))
    p = 500.0 * rng.random((50, 3))
    if kind == "linear":
        je, te = (jeos.LinearEquationOfState(rho_ref=1025.0, alpha=0.17),
                  teos.LinearEquationOfState(rho_ref=1025.0, alpha=0.17))
    else:
        je, te = jeos.JackettEquationOfState(), teos.JackettEquationOfState()
    for rho0 in (0.0, 1020.0):
        want = je.compute_rho(jnp.asarray(s), jnp.asarray(th), jnp.asarray(p),
                              rho0)
        got = te.compute_rho(torch.tensor(s), torch.tensor(th),
                             torch.tensor(p), rho0)
        close(got, want)
    # scalar pressure, as the density solver calls it
    close(te.eval(torch.tensor(s), torch.tensor(th), 0.0),
          je.eval(jnp.asarray(s), jnp.asarray(th), 0.0))


@pytest.mark.parametrize("kind", ["jackett", "linear"])
def test_equation_of_state_takes_numbers(kind):
    """Numbers and numpy arrays in, as the reference takes them
    (``tests/test_3d.py::test_eos_values``): the Jackett EOS clipped its
    salinity with ``torch.clamp_min``, which refuses a number."""
    je, te = {"jackett": (jeos.JackettEquationOfState(),
                          teos.JackettEquationOfState()),
              "linear": (jeos.LinearEquationOfState(),
                         teos.LinearEquationOfState())}[kind]
    for args in ((35.0, 25.0, 2000.0), (-1.0, 10.0, 0.0),
                 (np.array([35.0, 30.0]), np.array([25.0, 4.0]), 100.0)):
        got = te.compute_rho(*args, 1000.0)
        want = je.compute_rho(*args, 1000.0)
        assert not isinstance(got, torch.Tensor) or got.dtype == torch.float64
        close(got, want)


# -- diagnostics ---------------------------------------------------------
def test_expand_and_extract(case):
    u2 = case.rand(case.nc, 3, 2)
    close(tu3.expand_function_to_3d(torch.tensor(u2), NZ),
          ju3.expand_function_to_3d(jnp.asarray(u2), NZ))
    u3 = case.rand(case.nc, 3, NZ, 2)
    close(tu3.extract_surface_2d(torch.tensor(u3)),
          ju3.extract_surface_2d(jnp.asarray(u3)))
    close(tu3.extract_bottom_2d(torch.tensor(u3)),
          ju3.extract_bottom_2d(jnp.asarray(u3)))


@pytest.mark.parametrize("method", ["solve_weak", "solve"])
def test_vertical_velocity_sloped_bed(case, method):
    """The reference tests ``solve_weak`` only on a flat bed; here the bed
    slopes in both directions."""
    jw = ju3.VerticalVelocitySolver(case.ja, jnp.asarray(case.bathy))
    tw = tu3.VerticalVelocitySolver(case.ta, torch.tensor(case.bathy))
    uv = case.rand(case.nc, 3, NZ, 2, 2, scale=0.3)
    close(getattr(tw, method)(torch.tensor(uv), case.tg),
          getattr(jw, method)(jnp.asarray(uv), case.jg))


def test_weak_w_makes_uniform_tracer_stationary(case):
    """What the weak w is for: with it, the advection residual of a
    uniform tracer vanishes on every row away from the free surface."""
    tw = tu3.VerticalVelocitySolver(case.ta, torch.tensor(case.bathy))
    uv = torch.tensor(case.rand(case.nc, 3, NZ, 2, 2, scale=0.3))
    w = tw.solve_weak(uv, case.tg)
    eq = TTr(case.tm, case.ta, opts())
    ones = torch.ones(case.nc, 3, NZ, 2, dtype=F64)
    r = eq.residual(["HorizontalAdvectionTerm", "VerticalAdvectionTerm"],
                    {"salt_3d": ones}, {"salt_3d": ones},
                    {"uv_3d": uv, "w_3d": w}, {}, {}, geom=case.tg)["salt_3d"]
    scale = float(tw.weak_divergence_rhs(uv, case.tg).abs().max())
    interior = r[:, :, :-1].abs().max()   # all but the top layer
    assert float(interior) < 1e-11 * scale


def test_density_head_and_int_pg(case):
    salt = 35.0 + case.rand(case.nc, 3, NZ, 2)
    temp = 10.0 + 5.0 * case.rand(case.nc, 3, NZ, 2)
    jd = ju3.DensitySolver(jeos.LinearEquationOfState())
    td = tu3.DensitySolver(teos.LinearEquationOfState())
    jrho = jd.solve(jnp.asarray(salt), jnp.asarray(temp))
    trho = td.solve(torch.tensor(salt), torch.tensor(temp))
    close(trho, jrho)
    jb, tb = ju3.BaroclinicHeadCalculator(case.ja), \
        tu3.BaroclinicHeadCalculator(case.ta)
    jh = jb.compute_head(jrho, case.jg)
    th = tb.compute_head(trho, case.tg)
    close(th, jh)
    close(tb.compute_int_pg(th, case.tg), jb.compute_int_pg(jh, case.jg))
    # the quadratic (P2DG x P2) head and its int_pg
    jq = jb.compute_head(jrho, case.jg, quadratic=True)
    tq = tb.compute_head(trho, case.tg, quadratic=True)
    close(tq, jq)
    close(tb.compute_int_pg(tq, case.tg), jb.compute_int_pg(jq, case.jg))


# -- equations -----------------------------------------------------------
def mom_fields(case, visc):
    nv = case.jm.nv
    d = {
        "w_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-3),
        "w_mesh_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-4),
        "int_pg_3d": case.rand(case.nc, 3, NZ, 2, 2, scale=1e-5),
        "coriolis": 1e-4 + case.rand(nv, scale=1e-5),
        "coriolis_bg_uv_2d": case.rand(case.nc, 3, 2, scale=0.1),
        "viscosity_h": (5.0 if visc == "scalar"
                        else 5.0 + case.rand(case.nc, 3, NZ, 2)),
        "momentum_source_3d": case.rand(case.nc, 3, NZ, 2, 2, scale=1e-6),
    }
    jf, tf = jt(d)
    if visc == "scalar":  # the 3D step passes a 0-d array / tensor
        jf["viscosity_h"] = jnp.asarray(5.0)
        tf["viscosity_h"] = torch.tensor(5.0, dtype=F64)
    return jf, tf


@pytest.mark.parametrize("term,visc", [(t, "scalar") for t in MOM_TERMS]
                         + [("HorizontalViscosityTerm", "field"),
                            ("all", "scalar"), ("all", "field")])
def test_momentum_residual_per_term(case, term, visc):
    """Every term, with a scalar viscosity (the 3D step's) and with a 3D
    viscosity field (the reference's other accepted form)."""
    jeq, teq = JMom(case.jm, case.ja, opts()), TMom(case.tm, case.ta, opts())
    uv = case.rand(case.nc, 3, NZ, 2, 2, scale=0.2)
    jf, tf = mom_fields(case, visc)
    label = "all" if term == "all" else frozenset([term])
    want = jeq.residual(label, {"uv_3d": jnp.asarray(uv)},
                        {"uv_3d": jnp.asarray(uv)}, jf, jf, {},
                        geom=case.jg)["uv_3d"]
    got = teq.residual(label, {"uv_3d": torch.tensor(uv)},
                       {"uv_3d": torch.tensor(uv)}, tf, tf, {},
                       geom=case.tg)["uv_3d"]
    assert np.abs(np.asarray(want)).max() > 0
    close(got, want)


def tracer_fields(case):
    return jt({
        "uv_3d": case.rand(case.nc, 3, NZ, 2, 2, scale=0.2),
        "w_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-3),
        "w_mesh_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-4),
        "diffusivity_h": 30.0,
        "diffusivity_v": 1e-3,
        "source-salt_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-5),
    })


@pytest.mark.parametrize("term", TR_TERMS + ["all"])
def test_tracer_residual_per_term(case, term):
    jeq, teq = JTr(case.jm, case.ja, opts()), TTr(case.tm, case.ta, opts())
    c = 10.0 + case.rand(case.nc, 3, NZ, 2)
    jf, tf = tracer_fields(case)
    label = "all" if term == "all" else frozenset([term])
    want = jeq.residual(label, {"salt_3d": jnp.asarray(c)},
                        {"salt_3d": jnp.asarray(c)}, jf, jf, {},
                        geom=case.jg)["salt_3d"]
    got = teq.residual(label, {"salt_3d": torch.tensor(c)},
                       {"salt_3d": torch.tensor(c)}, tf, tf, {},
                       geom=case.tg)["salt_3d"]
    assert np.abs(np.asarray(want)).max() > 0
    close(got, want)


def test_packed_tracer_residual_is_per_component(case):
    """The packed path (trailing component axis, one pass) equals the
    scalar residual of each component: what the reference's ``vmap``
    computes."""
    teq = TTr(case.tm, case.ta, opts())
    _, tf = tracer_fields(case)
    tf.pop("source-salt_3d")
    cp = torch.tensor(np.stack([10.0 + case.rand(case.nc, 3, NZ, 2),
                                np.ones((case.nc, 3, NZ, 2))], axis=-1))
    packed = teq.residual("all", {"salt_3d": cp}, {"salt_3d": cp}, tf, tf,
                          {}, geom=case.tg)["salt_3d"]
    for i in range(2):
        one = teq.residual("all", {"salt_3d": cp[..., i]},
                           {"salt_3d": cp[..., i]}, tf, tf, {},
                           geom=case.tg)["salt_3d"]
        close(packed[..., i], one.numpy())


@pytest.mark.parametrize("eq", ["momentum", "tracer"])
def test_mass_term_and_inverse(case, eq):
    key, shape = (("uv_3d", (case.nc, 3, NZ, 2, 2)) if eq == "momentum"
                  else ("salt_3d", (case.nc, 3, NZ, 2)))
    jeq, teq = ((JMom(case.jm, case.ja, opts()), TMom(case.tm, case.ta,
                                                       opts()))
                if eq == "momentum" else
                (JTr(case.jm, case.ja, opts()), TTr(case.tm, case.ta,
                                                     opts())))
    u = case.rand(*shape)
    close(teq.mass_term({key: torch.tensor(u)}, case.tg)[key],
          jeq.mass_term({key: jnp.asarray(u)}, case.jg)[key])
    close(teq.mass_inverse({key: torch.tensor(u)}, case.tg)[key],
          jeq.mass_inverse({key: jnp.asarray(u)}, case.jg)[key])


def test_3d_boundary_conditions_raise(case):
    """Both 3D equations build with open boundaries, as the reference's
    do (they raised before the boundary vocabulary was ported; the terms
    are held in ``tests/test_torch_3d_bcs.py``)."""
    for eq, jeq, spec in ((TMom, JMom, {1: {"uv": 0.0}}),
                          (TTr, JTr, {1: {"value": 1.0}})):
        t, j = (eq(case.tm, case.ta, opts(), bnd_conditions=spec),
                jeq(case.jm, case.ja, opts(), bnd_conditions=spec))
        assert t.open_markers == j.open_markers
        assert sorted(t.bnd_keys) == sorted(j.bnd_keys)
    # the GLS closure is ported (tests/test_torch_turbulence.py): its
    # model is built on the 3D assembler and no longer raises
    assert TGLS(case.ta).asm3d is case.ta


# -- implicit vertical solves ------------------------------------------
def test_vdiff_implicit(case):
    f = 10.0 + case.rand(case.nc, 3, NZ, 2)
    nu = 1e-3 * (1.0 + case.rand(case.nc, 3, NZ, 2) ** 2)
    solver = JGLS.__new__(JGLS)
    want = solver._vdiff_implicit(jnp.asarray(f), jnp.asarray(nu),
                                  case.jg["Delta_nodes"], 300.0)
    close(vdiff_implicit(torch.tensor(f), torch.tensor(nu),
                         case.tg["Delta_nodes"], 300.0), want)
    close(TGLS._vdiff_implicit(torch.tensor(f), torch.tensor(nu),
                               case.tg["Delta_nodes"], 300.0), want)


@pytest.mark.parametrize("forcing", ["none", "drag", "drag_wind"])
def test_vertical_viscosity_implicit(case, forcing):
    """Both velocity components in one column solve, with the 3D step's
    law-of-wall bottom drag and a surface wind stress."""
    uv = case.rand(case.nc, 3, NZ, 2, 2, scale=0.2)
    nu = np.full((case.nc, 3, NZ, 2), 1e-3)
    Dn_j, Dn_t = case.jg["Delta_nodes"], case.tg["Delta_nodes"]
    z0, kappa = 0.005, 0.4
    cd_j = (kappa / jnp.log((0.5 * Dn_j[:, :, 0] + z0) / z0)) ** 2
    cd_t = (kappa / torch.log((0.5 * Dn_t[:, :, 0] + z0) / z0)) ** 2
    kw_j, kw_t = {}, {}
    if forcing != "none":
        kw_j.update(bottom_drag=cd_j, uv_bot=jnp.asarray(uv)[:, :, 0, 0])
        kw_t.update(bottom_drag=cd_t, uv_bot=torch.tensor(uv)[:, :, 0, 0])
    if forcing == "drag_wind":
        tau = case.rand(case.nc, 3, 2, scale=0.1) / 1020.0
        kw_j["stress_top"] = jnp.asarray(tau)
        kw_t["stress_top"] = torch.tensor(tau)
    want = j_vvi(jnp.asarray(uv), jnp.asarray(nu), Dn_j, 300.0, **kw_j)
    uv_t = torch.tensor(uv)
    got = t_vvi(uv_t, torch.tensor(nu), Dn_t, 300.0, **kw_t)
    close(got, want)
    close(uv_t, uv)  # the input is not updated in place


# -- limiter -----------------------------------------------------------
def overshoot_field(case):
    """A smooth stratified field with spikes that the limiter must cut."""
    x = case.jm.coords_np[case.jm.cells_np]                  # (nc, 3, 2)
    zs = np.array([[0.0, 1.0], [1.0, 2.0], [2.0, 3.0]])[None, None]
    u = (10.0 + 0.01 * x[..., 0, None, None] + 0.5 * zs
         + 0.0 * x[..., 1, None, None])
    u = u + case.rand(case.nc, 3, NZ, 2, scale=0.05)
    u[::3, 0, 1, 1] += 3.0
    u[1::4, 2, 0, 0] -= 2.0
    return u


@pytest.mark.parametrize("k", [None, 3])
def test_limiter_on_overshoots(case, k):
    jl, tl = JLim(case.jm, NZ), TLim(case.tm, NZ)
    u = overshoot_field(case)
    if k is not None:
        u = np.stack([u, -u, 2.0 * u + 1.0], axis=-1)
    want = jl.apply(jnp.asarray(u))
    got = tl.apply(torch.tensor(u))
    close(got, want)
    assert np.abs(got.numpy() - u).max() > 1.0  # the spikes were cut
    # element means are preserved
    mean_axes = (1, 3)
    close(got.numpy().mean(axis=mean_axes), u.mean(axis=mean_axes))


def test_limiter_passes_uniform_field(case):
    tl = TLim(case.tm, NZ)
    u = np.full((case.nc, 3, NZ, 2, 2), 7.3)
    u[..., 1] = -2.1
    got = tl.apply(torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, u, rtol=1e-15, atol=0)
    got = tl.apply(torch.tensor(u[..., 0])).numpy()
    np.testing.assert_allclose(got, u[..., 0], rtol=1e-15, atol=0)


# -- barotropic mode -------------------------------------------------------
def test_modesplit_terms(case):
    jeq = JMS(case.jm, JAsm(case.jm, JFS(case.jm, "DG", 1)), opts(), 40.0)
    teq = TMS(case.tm, TAsm(case.tm, TFS(case.tm, "DG", 1)), opts(), 40.0)
    assert [n for n, _, _ in teq.terms] == [n for n, _, _ in jeq.terms]


def test_modesplit_cn_step_with_momentum_source():
    """One assembled semi-implicit CN step of the reduced 2D mode, forced
    by a momentum source (the 3D step's split residual), with the
    barotropic solver settings of the 3D solver, on the periodic channel
    mesh the 3D bench uses."""
    case = Case("periodic")
    jm, tm = case.jm, case.tm
    bathy = case.bathy.mean() + 0.0 * case.elev  # depth ~35 m, per node
    jeq = JMS(jm, JAsm(jm, JFS(jm, "DG", 1)), opts(), jnp.asarray(bathy))
    teq = TMS(tm, TAsm(tm, TFS(tm, "DG", 1)), opts(), torch.tensor(bathy))
    dt = 4.0 * float(jm.cell_hmin_np.min()) / np.sqrt(9.81 * 40.0)
    params = dict(ksp_rtol=1e-5, ksp_max_it=48, gmres_restart=6)
    jst = JCN(jeq, dt, semi_implicit=True, solver_parameters=JNP(**params),
              assembled_solve=True)
    tst = TCN(teq, dt, semi_implicit=True, solver_parameters=TNP(**params),
              assembled_solve=True)
    state = {"elev": 0.3 * np.cos(2 * np.pi * jm.coords_np[:, 0] / LX)[
                 jm.cells_np],
             "uv": case.rand(case.nc, 3, 2, scale=0.05)}
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0,
              "coriolis": 1e-4 + case.rand(jm.nv, scale=1e-5),
              "viscosity_h": 5.0,
              "momentum_source": case.rand(case.nc, 3, 2, scale=1e-4)}
    jf, tf = jt(fields)
    jf = {k: jnp.asarray(v) for k, v in jf.items()}
    tf = {k: torch.as_tensor(v, dtype=F64) for k, v in tf.items()}
    a = jst.advance(0.0, {k: jnp.asarray(v) for k, v in state.items()},
                    jf, jf, {})
    b = tst.advance(0.0, {k: torch.tensor(v) for k, v in state.items()},
                    tf, tf, {})
    for k in ("elev", "uv"):
        close(b[k], a[k], rtol=1e-8)
        assert np.abs(b[k].numpy() - state[k]).max() > 1e-6
