"""The 3D model's open boundaries, tracer sources and viscosity fields
(ROADMAP A7c), ``thetis_tpu_torch`` against ``thetis_tpu`` (f64, CPU),
from the same numpy inputs, on a non-periodic 8x4 rectangle x 3 layers
with a sloped bed and a wavy free surface:

* every term of ``MomentumEquation3D`` under the 3D momentum conditions
  ``uv`` (a vector and a 3D field), ``un`` (a scalar and a 3D field) and
  ``symm``, with a scalar and a field viscosity;
* every term of ``TracerEquation3D`` under ``value`` and
  ``value-<label>`` (a number and a 3D field), the flow entering and
  leaving through the same marker; the uniform-field drift (a condition
  whose value the call does not pass keeps the interior value); the
  source in its two 4-D layouts;
* ``SmagorinskyViscosity.solve``;
* three steps of the whole model with both tracers under different
  ``value`` boundaries, a ``temperature_source_3d`` and a
  ``salinity_source_3d``, a CG1 and a DG ``horizontal_viscosity`` field,
  Smagorinsky, momentum ``symm``/``un`` and an ``elev`` plus ``flux`` 2D
  boundary: the per-tracer path;
* marked ``slow``, the reference's coupled baroclinic manufactured
  solution (``tests/test_baroclinic_mms.py``) through the port.

Tolerances: 1e-11 of max|ref| for the terms and the Smagorinsky
viscosity (the same algebra summed in other orders); 1e-9 of each field's
scale after three steps (the barotropic Krylov solve amplifies
roundoff)."""
import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.equations import utility3d as ju3  # noqa: E402
from thetis_tpu.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D as JMom)
from thetis_tpu.equations.tracer_3d import (  # noqa: E402
    TracerEquation3D as JTr)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.assembly3d import Assembler3D as JA3  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.fem.functionspace import Function as JFunction  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.mesh.extruded import ExtrudedMesh as JExt  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu.model.flowsolver3d import ModelOptions3d as JOpts  # noqa: E402
from thetis_tpu_torch.equations import utility3d as tu3  # noqa: E402
from thetis_tpu_torch.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D as TMom)
from thetis_tpu_torch.equations.tracer_3d import (  # noqa: E402
    TracerEquation3D as TTr)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.assembly3d import Assembler3D as TA3  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS)
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_keys, state3d_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh as TExt  # noqa: E402
from thetis_tpu_torch.model.flowsolver3d import (  # noqa: E402
    ModelOptions3d as TOpts)

F64 = torch.float64
NX, NY, NZ = 8, 4, 3
LX, LY = 40e3, 20e3
TERM_RTOL = 1e-11
STEP_RTOL = 1e-9
MOM_TERMS = ["HorizontalAdvectionTerm", "VerticalAdvectionTerm",
             "CoriolisTerm", "HorizontalViscosityTerm", "all"]
TR_TERMS = ["HorizontalAdvectionTerm", "VerticalAdvectionTerm",
            "HorizontalDiffusionTerm", "VerticalDiffusionTerm", "all"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    """Both packages' 3D assemblers on the open rectangle (markers 1-4:
    west, east, south, north), a bed sloping from 20 m (west) to 10 m, a
    wavy free surface, and seeded numpy fields."""

    def __init__(self):
        jm = jgen.RectangleMesh(NX, NY, LX, LY)
        tm = tgen.RectangleMesh(NX, NY, LX, LY, device="cpu", dtype=F64)
        self.jm, self.tm, self.nc = jm, tm, jm.nc
        self.ja = JA3(jm, JAsm(jm, JFS(jm, "DG", 1)), JExt(jm, NZ))
        self.ta = TA3(tm, TAsm(tm, TFS(tm, "DG", 1)), TExt(tm, NZ))
        xy = jm.coords_np
        self.bathy = (20.0 - 10.0 * xy[:, 0] / LX
                      + 2.0 * np.sin(np.pi * xy[:, 1] / LY))[jm.cells_np]
        self.elev = (0.3 * np.cos(np.pi * xy[:, 0] / LX)
                     * (0.5 + xy[:, 1] / LY))[jm.cells_np]
        self.jg = self.ja.layer_geometry(self.ja.ext.z_interfaces(
            jnp.asarray(self.bathy), jnp.asarray(self.elev)))
        self.tg = self.ta.layer_geometry(self.ta.ext.z_interfaces(
            torch.tensor(self.bathy), torch.tensor(self.elev)))
        self.rng = np.random.default_rng(7)
        # a velocity whose normal component changes sign along the west
        # and east sides: inflow and outflow on the same marker
        xc = jm.coords_np[jm.cells_np]
        u = 0.2 * np.sin(2 * np.pi * xc[..., 1] / LY)[:, :, None, None]
        uv = np.stack(np.broadcast_arrays(u, 0.05 * u), axis=-1)
        self.uv = uv + self.rand(self.nc, 3, NZ, 2, 2, scale=0.02)

    def rand(self, *shape, scale=1.0):
        return scale * self.rng.standard_normal(shape)


@pytest.fixture(scope="module")
def case():
    return Case()


def opts():
    return JOpts(), TOpts()


def close(got, want, rtol=TERM_RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def both(d):
    """numpy dict -> (jax dict, torch dict); Python scalars and None
    stay."""
    def j(v):
        return v if v is None or np.isscalar(v) else jnp.asarray(v)

    def t(v):
        return v if v is None or np.isscalar(v) else torch.tensor(v)

    return ({k: j(v) for k, v in d.items()}, {k: t(v) for k, v in d.items()})


def both_bnd(d):
    """{marker: {key: value}} -> (jax, torch)."""
    pairs = {m: both(spec) for m, spec in d.items()}
    return ({m: p[0] for m, p in pairs.items()},
            {m: p[1] for m, p in pairs.items()})


# -- momentum ------------------------------------------------------------
def momentum_bcs(case):
    """Condition sets by name: the conditions, and the values the step
    passes for them."""
    uv_field = case.rand(case.nc, 3, NZ, 2, 2, scale=0.1)
    un_field = case.rand(case.nc, 3, NZ, 2, scale=0.1)
    return {
        "uv_vector": {1: {"uv": np.array([0.15, -0.05])},
                      2: {"symm": None}},
        "uv_field": {2: {"uv": uv_field}, 3: {"symm": None}},
        "un_scalar": {2: {"un": -0.1}, 1: {"symm": None}},
        "un_field": {1: {"un": un_field}},
        "symm": {1: {"symm": None}, 2: {"symm": None}, 4: {"symm": None}},
    }


def mom_fields(case, visc):
    d = {
        "w_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-3),
        "w_mesh_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-4),
        "coriolis": 1.15e-4,
        "coriolis_bg_uv_2d": case.rand(case.nc, 3, 2, scale=0.1),
        "viscosity_h": (None if visc == "scalar"
                        else 5.0 + case.rand(case.nc, 3, NZ, 2) ** 2),
    }
    jf, tf = both(d)
    if visc == "scalar":  # the 3D step passes a 0-d array / tensor
        jf["viscosity_h"] = jnp.asarray(5.0)
        tf["viscosity_h"] = torch.tensor(5.0, dtype=F64)
    return jf, tf


@pytest.mark.parametrize("visc", ["scalar", "field"])
@pytest.mark.parametrize("term", MOM_TERMS)
@pytest.mark.parametrize("bcs", ["uv_vector", "uv_field", "un_scalar",
                                 "un_field", "symm"])
def test_momentum_residual_with_open_boundaries(case, bcs, term, visc):
    spec = momentum_bcs(case)[bcs]
    jb, tb = both_bnd(spec)
    jeq = JMom(case.jm, case.ja, opts()[0], bnd_conditions=jb)
    teq = TMom(case.tm, case.ta, opts()[1], bnd_conditions=tb)
    assert teq.open_markers == jeq.open_markers == sorted(spec)
    jf, tf = mom_fields(case, visc)
    label = "all" if term == "all" else frozenset([term])
    uv = case.uv
    want = jeq.residual(label, {"uv_3d": jnp.asarray(uv)},
                        {"uv_3d": jnp.asarray(uv)}, jf, jf, jb,
                        geom=case.jg)["uv_3d"]
    got = teq.residual(label, {"uv_3d": torch.tensor(uv)},
                       {"uv_3d": torch.tensor(uv)}, tf, tf, tb,
                       geom=case.tg)["uv_3d"]
    assert np.abs(np.asarray(want)).max() > 0
    close(got, want)


def test_open_boundary_changes_the_momentum_flux(case):
    """Not a comparison of two walls: the open condition changes the
    advective and viscous fluxes against the land default."""
    jf, tf = mom_fields(case, "scalar")
    uv = torch.tensor(case.uv)
    wall = TMom(case.tm, case.ta, opts()[1])
    _, tb = both_bnd(momentum_bcs(case)["uv_vector"])
    open_ = TMom(case.tm, case.ta, opts()[1], bnd_conditions=tb)
    for term in ("HorizontalAdvectionTerm", "HorizontalViscosityTerm"):
        r = [eq.residual(frozenset([term]), {"uv_3d": uv}, {"uv_3d": uv},
                         tf, tf, tb, geom=case.tg)["uv_3d"]
             for eq in (wall, open_)]
        assert float((r[0] - r[1]).abs().max()) > 1e-3 * float(
            r[0].abs().max()), term


# -- tracers -------------------------------------------------------------
def tracer_bcs(case):
    field = 20.0 + case.rand(case.nc, 3, NZ, 2)
    return {
        "value": {1: {"value": 32.0}, 2: {"value": 0.0}},
        "value_field": {1: {"value": field}},
        # the label's own key wins over the generic one
        "value_label": {2: {"value": 5.0, "value-salt_3d": 0.0},
                        1: {"value-temp_3d": 7.0}},
    }


def tracer_fields(case, src_layout):
    d = {
        "uv_3d": case.uv,
        "w_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-3),
        "w_mesh_3d": case.rand(case.nc, 3, NZ, 2, scale=1e-4),
        "diffusivity_h": 30.0,
        "diffusivity_v": 1e-3,
    }
    if src_layout == "dofs":
        d["source-salt_3d"] = case.rand(case.nc, 3, NZ, 2, scale=1e-5)
    elif src_layout == "quad":
        nq = len(case.ja.asm2d.space._tab_np["qw"])
        d["source-salt_3d"] = case.rand(case.nc, NZ, nq, 2, scale=1e-5)
    return both(d)


@pytest.mark.parametrize("term", TR_TERMS)
@pytest.mark.parametrize("bcs", ["value", "value_field", "value_label"])
def test_tracer_residual_with_values(case, bcs, term):
    spec = tracer_bcs(case)[bcs]
    jb, tb = both_bnd(spec)
    jeq = JTr(case.jm, case.ja, opts()[0], bnd_conditions=jb)
    teq = TTr(case.tm, case.ta, opts()[1], bnd_conditions=tb)
    c = 10.0 + case.rand(case.nc, 3, NZ, 2)
    jf, tf = tracer_fields(case, None)
    label = "all" if term == "all" else frozenset([term])
    want = jeq.residual(label, {"salt_3d": jnp.asarray(c)},
                        {"salt_3d": jnp.asarray(c)}, jf, jf, jb,
                        geom=case.jg)["salt_3d"]
    got = teq.residual(label, {"salt_3d": torch.tensor(c)},
                       {"salt_3d": torch.tensor(c)}, tf, tf, tb,
                       geom=case.tg)["salt_3d"]
    close(got, want)


def test_inflow_takes_the_value_outflow_the_interior(case):
    """On one marker with inflow and outflow facets the boundary value
    enters where the flow does: the advection residual moves with the
    value only on inflow facets' cells."""
    _, tf = tracer_fields(case, None)
    c = torch.tensor(10.0 + case.rand(case.nc, 3, NZ, 2))
    eq = TTr(case.tm, case.ta, opts()[1],
             bnd_conditions={1: {"value": 0.0}})
    adv = frozenset(["HorizontalAdvectionTerm"])

    def r(v):
        return eq.residual(adv, {"salt_3d": c}, {"salt_3d": c}, tf, tf,
                           {1: {"value": v}}, geom=case.tg)["salt_3d"]

    moved = (r(0.0) - r(50.0)).abs().amax(dim=(1, 2, 3))
    west = torch.as_tensor(np.isclose(
        case.jm.coords_np[case.jm.cells_np][..., 0], 0.0).sum(1) == 2)
    assert float(moved[~west].max()) == 0.0
    hit = moved[west] > 0
    assert bool(hit.any()) and not bool(hit.all())  # inflow and outflow


@pytest.mark.parametrize("bcs", ["value", "value_field", "value_label"])
def test_drift_keeps_the_interior_value(case, bcs):
    """The uniform-field drift passes no value (``bnd_r={}``): the
    conditions then let the interior value through, as with no condition
    at all, in both packages."""
    spec = tracer_bcs(case)[bcs]
    jb, tb = both_bnd(spec)
    jeq = JTr(case.jm, case.ja, opts()[0], bnd_conditions=jb)
    teq = TTr(case.tm, case.ta, opts()[1], bnd_conditions=tb)
    none = TTr(case.tm, case.ta, opts()[1])
    ones = np.ones((case.nc, 3, NZ, 2))
    jf, tf = tracer_fields(case, None)
    adv = frozenset(["HorizontalAdvectionTerm", "VerticalAdvectionTerm"])
    want = jeq.residual(adv, {"salt_3d": jnp.asarray(ones)},
                        {"salt_3d": jnp.asarray(ones)}, jf, jf, {},
                        geom=case.jg)["salt_3d"]
    got = teq.residual(adv, {"salt_3d": torch.tensor(ones)},
                       {"salt_3d": torch.tensor(ones)}, tf, tf, {},
                       geom=case.tg)["salt_3d"]
    close(got, want)
    plain = none.residual(adv, {"salt_3d": torch.tensor(ones)},
                          {"salt_3d": torch.tensor(ones)}, tf, tf, {},
                          geom=case.tg)["salt_3d"]
    assert torch.equal(got, plain)


@pytest.mark.parametrize("layout", ["dofs", "quad"])
def test_tracer_source_layouts(case, layout):
    """The source as the options give it (dofs) and as prepared quadrature
    values, resolved as the reference resolves them."""
    jeq, teq = JTr(case.jm, case.ja, opts()[0]), TTr(case.tm, case.ta,
                                                     opts()[1])
    c = 10.0 + case.rand(case.nc, 3, NZ, 2)
    jf, tf = tracer_fields(case, layout)
    src = frozenset(["SourceTerm"])
    want = jeq.residual(src, {"salt_3d": jnp.asarray(c)},
                        {"salt_3d": jnp.asarray(c)}, jf, jf, {},
                        geom=case.jg)["salt_3d"]
    got = teq.residual(src, {"salt_3d": torch.tensor(c)},
                       {"salt_3d": torch.tensor(c)}, tf, tf, {},
                       geom=case.tg)["salt_3d"]
    assert np.abs(np.asarray(want)).max() > 0
    close(got, want)
    tf["source-salt_3d"] = torch.zeros(case.nc, 5, NZ, 2, dtype=F64)
    with pytest.raises(ValueError, match="4-D tracer source"):
        teq.residual(src, {"salt_3d": torch.tensor(c)},
                     {"salt_3d": torch.tensor(c)}, tf, tf, {}, geom=case.tg)


# -- Smagorinsky -----------------------------------------------------------
@pytest.mark.parametrize("max_visc", [None, 0.5])
def test_smagorinsky_viscosity(case, max_visc):
    cs = 1.0 / np.sqrt(5.0)
    js = ju3.SmagorinskyViscosity(case.ja, cs=cs, max_visc=max_visc)
    ts = tu3.SmagorinskyViscosity(case.ta, cs=cs, max_visc=max_visc)
    want = js.solve(jnp.asarray(case.uv), case.jg)
    got = ts.solve(torch.tensor(case.uv), case.tg)
    close(got, want)
    assert float(got.min()) >= 1e-10
    if max_visc is not None:
        assert float(got.max()) <= max_visc


# -- three steps of the whole model ----------------------------------------
BND = {"shallow_water": {1: {"elev": 0.1}, 2: {"flux": -50.0}},
       "momentum": {1: {"symm": None}, 2: {"un": -50.0 / (LY * 10.0)}},
       "salt": {1: {"value": 32.0}, 2: {"value": 0.0}},
       "temp": {1: {"value": 10.0}, 2: {"value": 15.0}}}


def model_options(nc, rng):
    return dict(
        timestepper_type="SSPRK22", solve_salinity=True,
        solve_temperature=True, use_smagorinsky_viscosity=True,
        smagorinsky_coefficient=1.0 / np.sqrt(5.0),
        coriolis_frequency=1.15e-4, timestep=60.0,
        simulation_export_time=180.0, simulation_end_time=180.0,
        no_exports=True, use_limiter_for_tracers=True,
        horizontal_diffusivity=10.0,
        temperature_source_3d=1e-5 * rng.random((nc, 3, NZ, 2)),
        salinity_source_3d=-1e-5 * rng.random((nc, 3, NZ, 2)))


def sponge(jm, family):
    """A viscosity Function: 25 m^2/s over the western quarter on
    5 m^2/s, in CG1 or DG1 (the same nodal values)."""
    xv = jm.coords_np[:, 0]
    x = xv if family == "CG" else xv[jm.cells_np]
    visc = JFunction(JFS(jm, family, 1))
    visc.data = jnp.asarray(5.0 + 20.0 * (x < LX / 4))
    return visc


@pytest.fixture(scope="module")
def model_run():
    """Both solvers from one description: the options (with a CG1
    viscosity Function) and the boundary conditions; the reference's
    three steps in one compiled call, the port's three ``_step`` calls."""
    jm = jgen.RectangleMesh(NX, NY, LX, LY)
    tm = tgen.RectangleMesh(NX, NY, LX, LY, device="cpu", dtype=F64)
    rng = np.random.default_rng(3)
    xv = jm.coords_np
    bathy = 20.0 - 10.0 * xv[:, 0] / LX
    visc = sponge(jm, "CG")
    opts_ = model_options(jm.nc, rng)
    opts_["horizontal_viscosity"] = visc
    js = JFlow(jm, jnp.asarray(bathy), NZ)
    js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                           else v) for k, v in opts_.items()})
    for which, specs in BND.items():
        js.bnd_functions[which] = {m: dict(s) for m, s in specs.items()}
    ts = flowsolver3d_from_numpy(tm, bathy, NZ, opts_, bnd_functions=BND)
    xc = jm.coords_np[jm.cells_np]
    salt0 = np.broadcast_to((20 + 10 * xc[..., 0] / LX)[:, :, None, None],
                            (jm.nc, 3, NZ, 2)).copy()
    temp0 = 12 + rng.random((jm.nc, 3, NZ, 2))
    elev0 = 0.05 * np.cos(xc[..., 0] / LX * np.pi)
    js.assign_initial_conditions(elev=jnp.asarray(elev0),
                                 salt=jnp.asarray(salt0),
                                 temp=jnp.asarray(temp0))
    ts.assign_initial_conditions(elev=elev0, salt=salt0, temp=temp0)
    jst = js._get_state()
    j_out = js._advance_n_jit(jst, js._gather_swe_fields(),
                              js._gather_bnd_sw(), n=3)
    t_state = ts._get_state()
    t_fields = ts._gather_swe_fields()
    t_bnd = ts._gather_bnd_sw()
    out = t_state
    for _ in range(3):
        out = ts._step(out, t_fields, t_bnd)
    return dict(js=js, ts=ts, jm=jm, opts=opts_, bathy=bathy,
                t_state=t_state, t_bnd=t_bnd,
                t_fields=t_fields, j_fields=js._gather_swe_fields(),
                start=state3d_to_numpy(t_state),
                want={k: np.asarray(v) for k, v in j_out.items()},
                got=state3d_to_numpy(out))


@pytest.mark.parametrize("key", state3d_keys())
def test_three_steps_match_reference(model_run, key):
    want, got = model_run["want"][key], model_run["got"][key]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=STEP_RTOL,
        atol=STEP_RTOL * max(np.abs(want).max(), 1e-300))


def test_options_were_in_force(model_run):
    """The per-tracer path ran with its boundaries and sources, the
    viscosity field reached the 3D momentum at its cell nodes, and both
    tracers and the velocity moved."""
    ts, js = model_run["ts"], model_run["js"]
    assert hasattr(ts, "smagorinsky")
    assert ts.eq_salt.open_markers == ts.eq_temp.open_markers == [1, 2]
    assert ts.eq_momentum.open_markers == [1, 2]
    jf, tf = model_run["j_fields"], model_run["t_fields"]
    assert sorted(tf) == sorted(jf)
    for k in ("viscosity_h_cells", "source-temp_3d", "source-salt_3d"):
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))
    assert tuple(tf["viscosity_h_cells"].shape) == (ts.mesh2d.nc, 3)
    for k in ("salt_3d", "temp_3d", "uv_3d", "elev"):
        assert np.abs(model_run["got"][k] - model_run["start"][k]).max() \
            > 1e-4, k


def test_dg_viscosity_field_is_told_from_cg(model_run):
    """A DG1 viscosity with the CG1 one's nodal values: the same cell
    values in both packages, told apart by the space's family, and the
    same port step as the CG1 field's."""
    jm, ts = model_run["jm"], model_run["ts"]
    opts_ = dict(model_run["opts"], horizontal_viscosity=sponge(jm, "DG"))
    js = JFlow(jm, jnp.asarray(model_run["bathy"]), NZ)
    js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                           else v) for k, v in opts_.items()})
    js.create_fields()
    tm = tgen.RectangleMesh(NX, NY, LX, LY, device="cpu", dtype=F64)
    dg = flowsolver3d_from_numpy(tm, model_run["bathy"], NZ, opts_,
                                 bnd_functions=BND)
    dg.initialize()
    assert dg.options.horizontal_viscosity.function_space.family == "DG"
    jf, tf = js._gather_swe_fields(), dg._gather_swe_fields()
    for k in ("viscosity_h", "viscosity_h_cells"):
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))
    np.testing.assert_array_equal(
        tf["viscosity_h_cells"].numpy(),
        model_run["t_fields"]["viscosity_h_cells"].numpy())
    a = dg._step(model_run["t_state"], tf, model_run["t_bnd"])
    b = ts._step(model_run["t_state"], model_run["t_fields"],
                 model_run["t_bnd"])
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_boundary_values_are_read_when_the_step_is_built(model_run):
    """A 3D boundary value set after ``initialize()`` does not reach the
    step (the reference captures the values when it builds its step);
    the 2D ones are gathered anew."""
    ts = model_run["ts"]
    first = ts._step(model_run["t_state"], model_run["t_fields"],
                     ts._gather_bnd_sw())
    ts.bnd_functions["salt"][1]["value"] = 0.0
    try:
        again = ts._step(model_run["t_state"], model_run["t_fields"],
                         ts._gather_bnd_sw())
    finally:
        ts.bnd_functions["salt"][1]["value"] = 32.0
    assert torch.equal(again["salt_3d"], first["salt_3d"])
    ts.bnd_functions["shallow_water"][1]["elev"] = 0.2
    try:
        moved = ts._step(model_run["t_state"], model_run["t_fields"],
                         ts._gather_bnd_sw())
    finally:
        ts.bnd_functions["shallow_water"][1]["elev"] = 0.1
    assert not torch.equal(moved["elev"], first["elev"])


# -- the coupled baroclinic manufactured solution --------------------------
def _mms_module():
    path = os.path.join(os.path.dirname(__file__), "test_baroclinic_mms.py")
    spec = importlib.util.spec_from_file_location("_ref_baroclinic_mms",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mms_run_port(mms, d, refinement):
    """``tests/test_baroclinic_mms.py::_run_inner`` through the port."""
    from thetis_tpu_torch import config as tconfig
    from thetis_tpu_torch.model.flowsolver3d import FlowSolver

    nx, ny, nz = 4 * refinement, 4 * refinement, 2 * refinement
    mesh2d = tgen.PeriodicRectangleMesh(nx, ny, mms.LX, mms.LY,
                                        direction="both", device="cpu",
                                        dtype=F64)
    rho0_saved = tconfig.physical_constants["rho0"]
    tconfig.physical_constants["rho0"] = mms.RHO0
    try:
        s = FlowSolver(mesh2d, mms.DEPTH, nz)
        o = s.options
        o.update(dict(
            timestepper_type="SSPRK22", solve_salinity=False,
            solve_temperature=True, constant_salinity=mms.S_REF,
            use_baroclinic_formulation=True,
            use_implicit_vertical_diffusion=False, use_bottom_friction=False,
            use_turbulence=False, use_limiter_for_tracers=False,
            use_lax_friedrichs_velocity=True, coriolis_frequency=mms.F0,
            equation_of_state_type="linear",
            equation_of_state_options=dict(
                rho_ref=mms.RHO0, alpha=mms.ALPHA, beta=0.0,
                th_ref=mms.T_REF, s_ref=mms.S_REF),
            timestep=25.0 / refinement,
            simulation_export_time=50 * 25.0 / refinement,
            simulation_end_time=50 * 25.0 / refinement, no_exports=True))
        s.initialize()
        xc = mesh2d.coords_np[mesh2d.cells_np]
        z_if = -mms.DEPTH + np.linspace(0.0, 1.0, nz + 1) * mms.DEPTH
        z_nodes = np.stack([z_if[:-1], z_if[1:]], axis=-1)
        shape = (mesh2d.nc, 3, nz, 2)
        X = np.broadcast_to(xc[:, :, None, None, 0], shape)
        Y = np.broadcast_to(xc[:, :, None, None, 1], shape)
        Z = np.broadcast_to(z_nodes[None, None], shape)

        def ev(f):
            return np.broadcast_to(np.asarray(f(X, Y, Z), dtype=float),
                                   shape).copy()

        uv_exact = np.stack([ev(d["u"]), ev(d["v"])], axis=-1)
        temp_exact = ev(d["temp"])
        o.momentum_source_3d = torch.tensor(
            np.stack([ev(d["src_u"]), ev(d["src_v"])], axis=-1))
        o.temperature_source_3d = torch.tensor(ev(d["src_T"]))
        s.assign_initial_conditions(elev=np.zeros((mesh2d.nc, 3)),
                                    uv_3d=uv_exact, temp=temp_exact)
        s.iterate()
    finally:
        tconfig.physical_constants["rho0"] = rho0_saved
    area = np.asarray(mesh2d.cell_area_np)
    w = area[:, None, None, None] * (mms.DEPTH / nz / 2.0) / 3.0
    vol = mms.LX * mms.LY * mms.DEPTH
    uv = s.fields.uv_3d.data.numpy()
    temp = s.fields.temp_3d.data.numpy()
    assert np.isfinite(uv).all() and np.isfinite(temp).all()
    err_uv = np.sqrt(float((w[..., None] * (uv - uv_exact) ** 2).sum())
                     / vol)
    err_T = np.sqrt(float((w * (temp - temp_exact) ** 2).sum()) / vol)
    return err_uv, err_T


@pytest.mark.slow
@pytest.mark.parametrize("mms_case", ["intpg", "full"])
def test_baroclinic_mms_convergence_port(mms_case):
    """The reference test's ladder (refinements 1-3) and bounds: uv slope
    > 1.5 and T slope > 0.4 for 'full', > 1.5 for both under 'intpg'."""
    stats = pytest.importorskip("scipy.stats")
    pytest.importorskip("sympy")
    mms = _mms_module()
    d = mms._case(mms_case)
    refs = [1, 2, 3]
    out = [_mms_run_port(mms, d, r) for r in refs]
    h = np.log([mms.LX / (4 * r) for r in refs])
    slope_uv = stats.linregress(h, np.log([e[0] for e in out])).slope
    slope_T = stats.linregress(
        h, np.log([max(e[1], 1e-16) for e in out])).slope
    print(f"port baroclinic MMS {mms_case}: uv slope {slope_uv:.3f}, "
          f"T slope {slope_T:.3f}; errors "
          + ", ".join(f"uv {e[0]:.3e} T {e[1]:.3e}" for e in out))
    assert slope_uv > 1.5, f"uv slope {slope_uv}"
    assert slope_T > (0.4 if mms_case == "full" else 1.5), \
        f"temp slope {slope_T}"
    if mms_case == "intpg":
        assert out[-1][1] < 0.01 * 20.0
