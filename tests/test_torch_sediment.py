"""Suspended sediment and the Exner bed of ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): the closure's public functions on seeded
(uv, H, grad zb) with u = 0 and H below ksp among the points, and its
Jacobian products there (finite in the port's reverse mode); the residual
of each sediment and Exner term (the ``equilibrium`` boundary and the
open bedload flux among them), the Exner mass and its 6-iteration
inverse; the SWE residual on a moving bed; one and five model steps of
``tests/test_sediment.py``'s channel with and without Exner and with the
slide on a 27 degree bump; the reference tests' own bounds through the
port.

Tolerances: pointwise functions and term residuals 1e-12 of each
output's max; the Jacobian products 1e-10 of max (the port's reverse
mode and the reference's forward mode sum in other orders); model steps
1e-9 of each field's max (the elevation's of the 4 m depth: the channel's
is roundoff) at a Krylov budget that solves the SWE step to roundoff,
except the slide's fifth step: its slope threshold switches amplify
roundoff ~100 times a step in both packages alike (measured 4e-16, 4e-15,
1e-12, 2e-11, 3e-9 of max over steps 1-5), so step 5 is held to 1e-6."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import thetis_tpu as J  # noqa: E402
from thetis_tpu.model.options import ModelOptions2d as JOptions  # noqa: E402
from thetis_tpu.model.sediment_model import SedimentModel as JSed  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.model.options import ModelOptions2d as TOptions  # noqa: E402
from thetis_tpu_torch.model.sediment_model import SedimentModel as TSed  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def tensor(v):
    return torch.as_tensor(np.asarray(v), dtype=F64)
#: a Krylov budget that solves the channel's SWE step to roundoff
TIGHT = dict(ksp_rtol=1e-12, ksp_max_it=480, gmres_restart=48)
MODEL_RTOL = 1e-9
#: the scale of a field whose values are roundoff (the channel's
#: elevation): the water depth
FIELD_SCALE = {"elev": 4.0}


def close(got, want, rtol, scale=0.0):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), scale))


def sediment_options(opts_cls, size=1.6e-4, **kw):
    o = opts_cls()
    o.timestep = 2.0
    so = o.sediment_model_options
    so.average_sediment_size = size
    so.morphological_viscosity = 1e-6
    so.bed_reference_height = 0.025
    so.max_angle = 20.0
    so.sed_slide_length_scale = 5.0
    so.morphological_acceleration_factor = 10.0
    for k, v in kw.items():
        setattr(so, k, v)
    return o


def closure_inputs(n=40, nq=6):
    """Seeded (uv, H, grad zb, grad zb old) at n x nq points: u = 0 on a
    quarter of them, H below ksp (4.8e-4) and below a (0.0125) on some,
    a flat bed on a quarter and slopes up to 1 elsewhere."""
    rng = np.random.default_rng(5)
    uv = rng.uniform(-1.5, 1.5, (n, nq, 2))
    uv[: n // 4] = 0.0
    H = rng.uniform(0.05, 6.0, (n, nq))
    H[n // 4: n // 4 + 3] = rng.uniform(1e-5, 4e-4, (3, nq))
    H[n // 2: n // 2 + 3] = rng.uniform(1e-3, 1e-2, (3, nq))
    gz = rng.uniform(-1.0, 1.0, (n, nq, 2))
    gz[::4] = 0.0
    gz_old = gz + 0.05 * rng.standard_normal((n, nq, 2))
    gz_old[::4] = 0.0
    return uv, H, gz, gz_old


def models(**kw):
    return (JSed(sediment_options(JOptions, **kw), None),
            TSed(sediment_options(TOptions, **kw), None))


#: public function -> (call on a model, which of (uv, H, gz, gz_old) it
#: takes)
CLOSURE = {
    "erosion_concentration": lambda m, a: m.erosion_concentration(*a[:2]),
    "integrated_rouse": lambda m, a: m.integrated_rouse(*a[:2]),
    "get_erosion_term": lambda m, a: m.get_erosion_term(*a[:2]),
    "get_deposition_coefficient":
        lambda m, a: m.get_deposition_coefficient(*a[:2]),
    "get_equilibrium_tracer": lambda m, a: m.get_equilibrium_tracer(*a[:2]),
    "advective_velocity_correction":
        lambda m, a: m.get_advective_velocity_correction_factor(*a[:2]),
    "friction_qfc": lambda m, a: m._friction(a[1])[0],
    "friction_mu": lambda m, a: m._friction(a[1])[1],
    "bedload_x": lambda m, a: m.get_bedload_term(a[0], a[1], a[3], a[2])[0],
    "bedload_y": lambda m, a: m.get_bedload_term(a[0], a[1], a[3], a[2])[1],
    "slide": lambda m, a: m.get_sediment_slide_term(a[2]),
    "slide_region": lambda m, a: m.get_sediment_slide_term(
        a[2], (a[1] > 1.0) * 1.0),
}
#: closure switches: default (angle + slope corrections), neither
SWITCHES = {"corrections": {}, "no_corrections": dict(
    use_angle_correction=False, use_slope_mag_correction=False,
    use_advective_velocity_correction=False)}


@pytest.mark.parametrize("switches", sorted(SWITCHES))
@pytest.mark.parametrize("name", sorted(CLOSURE))
def test_closure_matches_reference(name, switches):
    jm, tm = models(**SWITCHES[switches])
    args = closure_inputs()
    want = CLOSURE[name](jm, [jnp.asarray(a) for a in args])
    got = CLOSURE[name](tm, [torch.as_tensor(a) for a in args])
    if isinstance(want, float):
        assert got == want
        return
    close(got, want, 1e-12)


@pytest.mark.parametrize("size", [5e-5, 1.6e-4, 2e-3, 0.2])
def test_closure_constants(size):
    """Critical Shields number, settling velocity and D* for each branch
    of the reference's tables (fine sand, medium sand, gravel and a
    D* > 150 cobble)."""
    jm, tm = models(size=size)
    for k in ("dstar", "thetacr", "taucr", "settling_velocity", "R", "ksp",
              "a"):
        assert getattr(tm, k) == pytest.approx(getattr(jm, k), rel=1e-15), k


def test_dstar_below_one_raises():
    with pytest.raises(ValueError, match="dstar value less than 1"):
        TSed(sediment_options(TOptions, size=1e-5), None)


def _reverse_products(f, x, v, u):
    """``(J v, J^T u)`` by reverse mode: J v by reverse over reverse, as
    the port's Newton products (``solvers/newton.py``), whose graph is
    that of J^T w."""
    x = x.clone().requires_grad_(True)
    y = f(x)
    w = torch.zeros_like(y, requires_grad=True)
    (g,) = torch.autograd.grad(y, x, w, create_graph=True)
    (jv,) = torch.autograd.grad(g, w, v)
    (jtu,) = torch.autograd.grad(f(x), x, u)
    return jv, jtu


#: closure functions of the unknowns the Newton solves differentiate:
#: H (the Exner bed through the depth), uv and the implicit bed gradient
JVP_CASES = {
    "erosion_dH": (CLOSURE["get_erosion_term"], 1),
    "deposition_dH": (CLOSURE["get_deposition_coefficient"], 1),
    "deposition_duv": (CLOSURE["get_deposition_coefficient"], 0),
    "bedload_dH": (CLOSURE["bedload_x"], 1),
    "bedload_duv": (CLOSURE["bedload_y"], 0),
    "bedload_dgz": (CLOSURE["bedload_x"], 2),
    "slide_dgz": (CLOSURE["slide"], 2),
}


@pytest.mark.parametrize("case", sorted(JVP_CASES))
def test_closure_jacobian_products_finite(case):
    """At u = 0, on a flat bed and at H below a the port's reverse-mode
    products J v and J^T u are finite (every infinite-derivative branch
    has a sanitised argument, so no zero cotangent meets an infinite
    derivative) and J v equals the reference's forward-mode product
    where that is finite."""
    fn, i = JVP_CASES[case]
    jm, tm = models()
    args = list(closure_inputs())
    rng = np.random.default_rng(3)
    v = rng.standard_normal(args[i].shape)

    def jf(x):
        a = [jnp.asarray(y) for y in args]
        a[i] = x
        return fn(jm, a)

    _, want = jax.jvp(jf, (jnp.asarray(args[i]),), (jnp.asarray(v),))
    want = np.asarray(want)

    def tf(x):
        a = [torch.as_tensor(y) for y in args]
        a[i] = x
        return fn(tm, a)

    u = rng.standard_normal(want.shape)
    got, jtu = _reverse_products(tf, torch.as_tensor(args[i]),
                                 torch.as_tensor(v), torch.as_tensor(u))
    got = got.numpy()
    assert np.isfinite(got).all()
    assert bool(torch.isfinite(jtu).all())
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10,
                               atol=1e-10 * np.abs(want[fin]).max())


# -- the equations' terms ---------------------------------------------------
@pytest.fixture(scope="module")
def solvers():
    """:func:`term_solvers` for each form, built once for the file."""
    return {c: term_solvers(c) for c in (False, True)}


def term_solvers(conservative=False):
    """A reference FlowSolver2d with suspended sediment, bedload, the slide
    and Exner on a 8x4 channel (an ``equilibrium`` sediment inflow, an
    open outflow), initialized, and the port's from it."""
    jm = J.RectangleMesh(8, 4, 160.0, 40.0)
    x = jm.coords_np
    bath = 4.0 - 2.0 * np.exp(-((x[:, 0] - 80.0) / 15.0) ** 2)
    s = J.solver2d.FlowSolver2d(jm, jnp.asarray(bath))
    o = s.options
    o.timestep = 2.0
    o.simulation_export_time = 2.0
    o.simulation_end_time = 2.0
    o.no_exports = True
    o.horizontal_viscosity = J.Constant(0.1)
    o.horizontal_diffusivity = J.Constant(0.15)
    so = o.sediment_model_options
    so.solve_suspended_sediment = True
    so.use_bedload = True
    so.use_exner = True
    so.use_sediment_slide = True
    so.use_sediment_conservative_form = conservative
    so.max_angle = 5.0
    so.sed_slide_length_scale = 5.0
    so.average_sediment_size = 1.6e-4
    so.morphological_viscosity = 1e-6
    so.morphological_acceleration_factor = 10.0
    s.bnd_functions["shallow_water"] = {1: {"flux": J.Constant(-80.0)},
                                        2: {"elev": J.Constant(0.0)}}
    s.bnd_functions["sediment"] = {
        1: {"flux": J.Constant(-80.0), "equilibrium": None},
        2: {"elev": J.Constant(0.0)}}
    s.initialize()
    tm = T.RectangleMesh(8, 4, 160.0, 40.0, device="cpu")
    return s, flowsolver2d_from_reference(s, tm)


def term_inputs(nc, nv):
    """Seeded states: a fast flow (0.5-1.5 m/s, so the bed erodes), a
    small elevation, a sediment concentration and a perturbed bed."""
    rng = np.random.default_rng(17)
    return dict(
        uv=np.stack([rng.uniform(0.5, 1.5, (nc, 3)),
                     rng.uniform(-0.3, 0.3, (nc, 3))], axis=-1),
        elev=0.05 * rng.standard_normal((nc, 3)),
        sed=rng.uniform(0.0, 2e-3, (nc, 3)),
        sed_old=rng.uniform(0.0, 2e-3, (nc, 3)),
        bed=rng.uniform(-0.2, 0.2, nv),
        bed_old=rng.uniform(-0.2, 0.2, nv))


SEDIMENT_TERMS = ("HorizontalAdvectionTerm", "HorizontalDiffusionTerm",
                  "SedimentErosionTerm", "SedimentDepositionTerm", "all")


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("term", SEDIMENT_TERMS)
def test_sediment_terms_match_reference(term, conservative, solvers):
    """Each term of the sediment equation, with the model's fields (the
    advective-velocity factor and the moving bed among them) and the
    ``equilibrium`` inflow."""
    ref, port = solvers[conservative]
    mesh = port.mesh2d
    d = term_inputs(mesh.nc, mesh.nv)
    bed = ref.fields.bathymetry_2d.data + d["bed"]
    out = []
    for s, arr in ((ref, jnp.asarray), (port, tensor)):
        m = s.sediment_model
        f = {"uv_2d": arr(d["uv"]), "elev_2d": arr(d["elev"]),
             "bathymetry_2d": arr(np.asarray(bed)),
             "diffusivity_h-sediment_2d": arr(0.15),
             "lax_friedrichs_tracer_scaling_factor": arr(1.0)}
        H = s.depth.total_depth(arr(np.asarray(bed))[s.mesh2d.cells],
                                f["elev_2d"])
        f["tracer_advective_velocity_factor"] = \
            m.get_advective_velocity_correction_factor(f["uv_2d"], H)
        r = s.eq_sediment.residual(
            term, {"sediment_2d": arr(d["sed"])},
            {"sediment_2d": arr(d["sed_old"])}, f, f,
            s._gather_bnd("sediment"))
        out.append(r["sediment_2d"])
    assert float(np.abs(np.asarray(out[0])).max()) > 0.0
    close(out[1], out[0], 1e-12)


EXNER_TERMS = ("ExnerSourceTerm", "ExnerBedloadTerm",
               "ExnerSedimentSlideTerm", "all")


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("term", EXNER_TERMS)
def test_exner_terms_match_reference(term, conservative, solvers):
    """Each Exner term on a perturbed bed (the bedload's open-boundary
    flux on both open markers)."""
    ref, port = solvers[conservative]
    d = term_inputs(port.mesh2d.nc, port.mesh2d.nv)
    b0 = np.asarray(ref.fields.bathymetry_2d.data)
    out = []
    for s, arr in ((ref, jnp.asarray), (port, tensor)):
        f = {"uv_2d": arr(d["uv"]), "elev_2d": arr(d["elev"]),
             "sediment": arr(d["sed"])}
        r = s.eq_exner.residual(
            term, {"bathymetry": arr(b0 + d["bed"])},
            {"bathymetry": arr(b0 + d["bed_old"])}, f, f, {})
        out.append(r["bathymetry"])
    assert float(np.abs(np.asarray(out[0])).max()) > 0.0
    close(out[1], out[0], 1e-12)


@pytest.mark.parametrize("which", ["mass_term", "mass_inverse"])
def test_exner_mass_matches_reference(which, solvers):
    """The consistent CG1 mass and its inverse by the reference's 6
    lumped-Jacobi Richardson iterations (not a converged solve: the
    result is the 6-iteration one)."""
    ref, port = solvers[False]
    v = np.random.default_rng(2).standard_normal(port.mesh2d.nv)
    want = getattr(ref.eq_exner, which)({"bathymetry": jnp.asarray(v)})
    got = getattr(port.eq_exner, which)({"bathymetry": torch.as_tensor(v)})
    close(got["bathymetry"], want["bathymetry"], 1e-12)
    assert port.eq_exner.MASS_ITERATIONS == 6


def test_swe_residual_on_a_moving_bed(solvers):
    """The SWE residual with ``fields["bathymetry_2d"]`` (an Exner bed)
    against the reference's; it differs from the static bed's."""
    ref, port = solvers[False]
    d = term_inputs(port.mesh2d.nc, port.mesh2d.nv)
    b0 = np.asarray(ref.fields.bathymetry_2d.data)
    rng = np.random.default_rng(4)
    old = dict(uv=d["uv"] + 0.1 * rng.standard_normal(d["uv"].shape),
               elev=d["elev"] + 0.01 * rng.standard_normal(d["elev"].shape))
    out = []
    for s, arr in ((ref, jnp.asarray), (port, tensor)):
        f = dict(s._gather_swe_fields())
        st = {"uv": arr(d["uv"]), "elev": arr(d["elev"])}
        st_old = {k: arr(v) for k, v in old.items()}
        bnd = s._gather_bnd("shallow_water")
        static = s.eq_sw.residual("all", st, st_old, f, f, bnd)
        f["bathymetry_2d"] = arr(b0 + d["bed"])
        out.append((s.eq_sw.residual("all", st, st_old, f, f, bnd), static))
    for k in ("uv", "elev"):
        close(out[1][0][k], out[0][0][k], 1e-12)
        assert float(np.abs(np.asarray(out[0][0][k] - out[0][1][k])).max()) \
            > 1e-6


# -- the model ----------------------------------------------------------------
def slide_channel(pkg, use_slide=True, mesh=None):
    """``test_sediment.py::test_sediment_slide_relaxes_steep_slope``'s
    set-up: Exner with the slide (15 degrees, 5 m) on a 27 degree bump,
    no flow, 32x4; initialized."""
    lx, ly = 160.0, 40.0
    mesh = mesh or pkg.RectangleMesh(32, 4, lx, ly)
    x = mesh.coords_np[:, 0]
    bath = pkg.Function(pkg.FunctionSpace(mesh, "CG", 1))
    bath.data = bath.data * 0 + (4.0 + 6.0 * np.exp(
        -(((x - lx / 2) / 10.0) ** 2)))
    so = pkg.solver2d.FlowSolver2d(mesh, bath)
    o = so.options
    o.timestep = 2.0
    o.simulation_export_time = 100.0
    o.simulation_end_time = 100.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = pkg.Constant(0.1)
    o.norm_smoother = 0.1
    sed = o.sediment_model_options
    sed.use_exner = True
    sed.use_sediment_slide = use_slide
    sed.max_angle = 15.0
    sed.sed_slide_length_scale = 5.0
    sed.average_sediment_size = 1.6e-4
    sed.morphological_viscosity = 1e-6
    return so


def reference_case(case):
    from test_sediment import sediment_channel

    if case == "slide":
        s = slide_channel(J)
        s.assign_initial_conditions(uv=jnp.asarray([0.0, 0.0]), elev=0.0)
    elif case == "channel":
        s = sediment_channel()
    else:
        # the bump with bedload and Exner at 1 m/s (the test's 0.25 m/s
        # stays below the critical Shields number: nothing would move)
        s = sediment_channel(use_exner=True, bump=True)
        s.bnd_functions["shallow_water"][1]["flux"].assign(-160.0)
        s.bnd_functions["sediment"][1]["flux"].assign(-160.0)
        s.assign_initial_conditions(uv=jnp.asarray([1.0, 0.0]), elev=0.0)
    # rebuild the steppers with a Krylov budget that solves the SWE step
    # to roundoff (the channel's defaults stop at 1e-7)
    s.options.swe_timestepper_options.solver_parameters = JNP(**TIGHT)
    s.create_timestepper()
    return s


def step_states(s, n):
    """Run ``n`` steps through ``iterate()`` with an export after each,
    returning the state after each step (numpy)."""
    dt = s.options.timestep
    s.options.simulation_export_time = dt
    s.options.simulation_end_time = n * dt
    out = []
    s.iterate(export_func=lambda: out.append(
        {k: np.array(v) for k, v in s._get_state().items()}))
    return out[1:] if len(out) > n else out


@pytest.mark.parametrize("case", ["channel", "exner", "slide"])
def test_model_steps_match_reference(case):
    """One and five steps through ``iterate()``: the channel (suspended
    sediment with an ``equilibrium`` inflow), the bump with suspended
    sediment, bedload and Exner (morfac 10) at 1 m/s and the 27 degree
    bump under the slide; the same Krylov path in both packages."""
    ref = reference_case(case)
    tm = T.RectangleMesh(*((32, 4) if case == "slide" else (16, 4)), 160.0,
                         40.0, device="cpu")
    port = flowsolver2d_from_reference(ref, tm)
    assert sorted(port._get_state()) == sorted(ref._get_state())
    want = step_states(ref, 5)
    got = step_states(port, 5)
    assert len(want) == len(got) == 5
    for i in (0, 4):
        rtol = 1e-6 if (case, i) == ("slide", 4) else MODEL_RTOL
        for k, v in want[i].items():
            if np.abs(v).max() == 0.0:
                assert np.abs(got[i][k]).max() == 0.0, k
                continue
            close(got[i][k], v, rtol, FIELD_SCALE.get(k, 0.0))
    if case != "channel":
        moved = np.abs(want[4]["bathymetry"]
                       - np.asarray(ref.bathymetry_dof)).max()
        assert moved > 1e-6, moved
    if case == "exner":
        assert np.abs(want[4]["sediment_2d"]).max() > 1e-6
    st = port.exner_stepper.stats if case != "channel" else \
        port.sediment_stepper.stats
    assert st["newton_iterations"] == 1


def test_interop_carries_sediment(solvers):
    """A reference solver with sediment and Exner becomes a port solver
    with the same sediment options, boundaries and state keys."""
    ref, port = solvers[True]
    rso = ref.options.sediment_model_options
    pso = port.options.sediment_model_options
    for k, v in vars(rso).items():
        if k.startswith("_"):
            continue
        pv = getattr(pso, k)
        if type(v).__name__ == "Constant":
            assert float(pv) == float(v), k
        else:
            assert pv == v, k
    assert sorted(port.bnd_functions["sediment"]) == [1, 2]
    assert sorted(port.bnd_functions["sediment"][1]) == ["equilibrium",
                                                          "flux"]
    assert port.bnd_functions["sediment"][1]["equilibrium"] is None
    assert sorted(port._get_state()) == sorted(ref._get_state()) == [
        "bathymetry", "elev", "sediment_2d", "uv"]
    assert port.eq_sediment.conservative["sediment_2d"]
    assert type(port.exner_stepper).__name__ == "CrankNicolson"
    assert port.exner_stepper.semi_implicit


# -- the reference tests through the port --------------------------------------
def port_channel(use_exner=False, bump=False, t_end=200.0):
    """``test_sediment.py::sediment_channel`` through the port's facade
    (its import line changed, the mesh on the CPU)."""
    lx, ly = 160.0, 40.0
    mesh2d = T.RectangleMesh(16, 4, lx, ly, device="cpu")
    P1 = T.FunctionSpace(mesh2d, "CG", 1)
    x, y = T.SpatialCoordinate(mesh2d)
    if bump:
        bath = T.Function(P1).interpolate(
            4.0 - 0.8 * torch.exp(-(((x - lx / 2) / 20.0) ** 2)))
    else:
        bath = T.Function(P1).assign(4.0)
    so = T.solver2d.FlowSolver2d(mesh2d, bath)
    o = so.options
    o.timestep = 2.0
    o.simulation_export_time = t_end
    o.simulation_end_time = t_end
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = T.Constant(0.1)
    o.horizontal_diffusivity = T.Constant(0.15)
    o.norm_smoother = 0.1
    sed = o.sediment_model_options
    sed.solve_suspended_sediment = True
    sed.use_bedload = use_exner
    sed.use_exner = use_exner
    sed.use_angle_correction = False
    sed.use_secondary_current = False
    sed.average_sediment_size = 1.6e-4
    sed.morphological_viscosity = 1e-6
    sed.bed_reference_height = 0.025
    sed.morphological_acceleration_factor = 10.0 if use_exner else 1.0
    so.bnd_functions["shallow_water"] = {
        1: {"flux": T.Constant(-40.0)}, 2: {"elev": T.Constant(0.0)}}
    so.bnd_functions["sediment"] = {
        1: {"flux": T.Constant(-40.0), "equilibrium": None},
        2: {"elev": T.Constant(0.0)}}
    so.assign_initial_conditions(uv=torch.tensor([0.25, 0.0], dtype=F64),
                                 elev=0.0)
    return so


def test_port_suspended_sediment_equilibrium():
    """``test_suspended_sediment_equilibrium`` through the port, at its
    bound (median relative gap < 0.25 in the channel's middle)."""
    so = port_channel(t_end=400.0)
    so.iterate()
    asm = so.asm
    uv_q = asm.cell_values(so.fields.uv_2d.data)
    eta_q = asm.cell_values(so.fields.elev_2d.data)
    H_q = so.depth.total_depth(so.eq_sw.bathy_q, eta_q)
    c_eq = so.sediment_model.get_equilibrium_tracer(uv_q, H_q).numpy()
    c_q = asm.cell_values(so.fields.sediment_2d.data).numpy()
    xq = asm.cell_values(T.Function(so.function_spaces.Q_2d).interpolate(
        lambda x, y: x).data).numpy()
    mask = (xq > 60.0) & (xq < 120.0)
    rel = np.abs(c_q - c_eq)[mask] / (np.abs(c_eq)[mask] + 1e-12)
    assert so.iteration == 200
    assert np.isfinite(c_q).all()
    assert c_q.min() >= -1e-12, "sediment went negative"
    assert np.median(rel) < 0.25, f"median relative gap {np.median(rel)}"


def test_port_sediment_slide_inactive_below_max_angle():
    """Gentle slopes give an exactly zero slide coefficient."""
    mesh2d = T.RectangleMesh(8, 4, 160.0, 40.0, device="cpu")
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(
        T.FunctionSpace(mesh2d, "CG", 1)).assign(4.0))
    o = so.options
    o.timestep = 2.0
    sed = o.sediment_model_options
    sed.max_angle = 32.0
    sed.sed_slide_length_scale = 5.0
    sed.average_sediment_size = 1.6e-4
    sed.morphological_viscosity = 1e-6
    m = TSed(o, mesh2d)
    gz = torch.full((mesh2d.nc, 4, 2), 0.1, dtype=F64)  # 5.7 deg << 32 deg
    assert float(m.get_sediment_slide_term(gz).abs().max()) == 0.0


@pytest.mark.slow
def test_port_exner_bed_evolution():
    """``test_exner_bed_evolution`` through the port: the bed changes,
    stays finite, most near the crest."""
    so = port_channel(use_exner=True, bump=True, t_end=100.0)
    z0 = so.fields.bathymetry_2d.data.clone().numpy()
    so.iterate()
    z1 = so.fields.bathymetry_2d.data.numpy()
    assert np.isfinite(z1).all()
    dz = z1 - z0
    assert np.abs(dz).max() > 1e-6, "bed did not evolve"
    x = so.mesh2d.coords_np[:, 0]
    crest = (x > 60.0) & (x < 100.0)
    assert np.abs(dz[crest]).max() > np.abs(dz[~crest]).max() * 0.5


@pytest.mark.slow
def test_port_sediment_slide_relaxes_steep_slope():
    """``test_sediment_slide_relaxes_steep_slope`` through the port: the
    slide relaxes a 27 degree bump toward, not past, 15 degrees."""
    def run(use_slide):
        mesh = T.RectangleMesh(32, 4, 160.0, 40.0, device="cpu")
        so = slide_channel(T, use_slide, mesh=mesh)
        so.assign_initial_conditions(uv=torch.zeros(2, dtype=F64), elev=0.0)
        so.iterate()
        zb = so.fields.bathymetry_2d.data
        gz = so.asm.cell_grads(zb[mesh.cells]).numpy()
        return float(np.sqrt((gz**2).sum(-1)).max())

    slope_off = run(False)
    slope_on = run(True)
    tanphi = np.tan(np.radians(15.0))
    assert slope_off > 0.4, slope_off
    assert slope_on < slope_off - 0.05, (slope_on, slope_off)
    assert slope_on > 0.9 * tanphi
