"""The dg-cg family of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64,
CPU): the P1DG velocity x P2 CG elevation shallow-water equations
(``equations/shallowwater_dgcg.py``) and their ``FlowSolver2d`` branch.

Both packages get the same numpy-seeded inputs on a 16x2 rectangle with
a sloped CG1 bed, an open ``elev`` boundary, an ``un`` inflow and a
``drag`` wall.  Tolerances: the P2 cross-tabulations and the CG2 mass
1e-14 of scale; the CG operators (evaluation, projection, mass apply, the
30-iteration PCG mass inverse, the L2 norm) and every residual term
1e-12 of the largest entry (the CG2 mass inverse with the reference's
loop on the port's preconditioner: the reference's lumped one is
repaired here); one and three model steps through
``iterate()`` (the Newton CN under the mass preconditioner, the
semi-implicit CN and PressureProjectionPicard under the wave-Schur PC)
1e-10 of each field's max.  The reference test's own cases
(``tests/test_dgcg.py``) run through the port with its bounds: the
closed-basin volume here, the 100x1 standing waves under ``-m slow``
(minutes on the CPU; the card runs them in ``chip_smoke.py``'s phase
25)."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402
import thetis_tpu as J  # noqa: E402
from thetis_tpu.equations.shallowwater_dgcg import (  # noqa: E402
    ShallowWaterEquationsDGCG as JDGCG)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_dgcg import (  # noqa: E402
    ShallowWaterEquationsDGCG as TDGCG)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.solvers.newton import NewtonParameters as TNP  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LX, LY, NX, NY = 5e3, 1e3, 16, 2
TIGHT = dict(ksp_rtol=1e-12, ksp_max_it=240, gmres_restart=40)


def tensor(v):
    return torch.as_tensor(np.asarray(v), dtype=F64)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def options():
    return SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0, wetting_and_drying_alpha=0.5)


BND = {1: {"elev": 0.05}, 2: {"un": -0.2}, 3: {"drag": 0.01}}


@pytest.fixture(scope="module")
def eq_pair():
    """(reference, port) DGCG equations on the same mesh and bed."""
    jm = J.RectangleMesh(NX, NY, LX, LY)
    tm = T.RectangleMesh(NX, NY, LX, LY, device="cpu")
    bathy = 20.0 + 5.0 * jm.coords_np[:, 0] / LX
    out = []
    for pkg, m, asm_cls, eq_cls, arr in (
            (J, jm, JAsm, JDGCG, jnp.asarray),
            (T, tm, TAsm, TDGCG, tensor)):
        asm = asm_cls(m, pkg.FunctionSpace(m, "DG", 1))
        eq = eq_cls(m, asm, pkg.FunctionSpace(m, "CG", 2), options(),
                    arr(bathy), bnd_conditions=BND)
        out.append(eq)
    return tuple(out)


def seeded(eq, seed=3):
    """A state, a lagged state, fields and boundary values (numpy)."""
    rng = np.random.default_rng(seed)
    nc, nv, n_eta = eq.mesh.nc, eq.mesh.nv, eq.n_eta
    x = eq.mesh.coords_np
    state = {"uv": 0.3 * rng.standard_normal((nc, 3, 2)),
             "elev": 0.2 * rng.standard_normal(n_eta)}
    old = {"uv": 0.3 * rng.standard_normal((nc, 3, 2)),
           "elev": 0.2 * rng.standard_normal(n_eta)}
    fields = {
        "coriolis": 1e-4 + 1e-5 * x[:, 1] / LY,
        "viscosity_h": 2.0 + rng.random(nv),
        "wind_stress": 0.1 * rng.standard_normal((nv, 2)),
        "atmospheric_pressure": 1e5 + 100.0 * x[:, 0] / LX,
        "quadratic_drag_coefficient": 2.5e-3,
        "linear_drag_coefficient": 1e-4,
        "momentum_source": 1e-3 * rng.standard_normal((nv, 2)),
        "volume_source": 1e-4 * rng.random(nv),
        "lax_friedrichs_velocity_scaling_factor": 1.0,
    }
    bnd = {1: {"elev": 0.05}, 2: {"un": -0.2}, 3: {"drag": 0.01}}
    return state, old, fields, bnd


def both(eq_pair, fn, *np_args):
    """``fn(eq, *args)`` in each package on the same numpy inputs."""
    je, te = eq_pair

    def conv(a, arr):
        if isinstance(a, dict):
            return {k: conv(v, arr) for k, v in a.items()}
        if a is None or isinstance(a, str):
            return a
        return arr(a)

    return (fn(je, *[conv(a, jnp.asarray) for a in np_args]),
            fn(te, *[conv(a, tensor) for a in np_args]))


def test_cg2_tabulations_match_reference(eq_pair):
    je, te = eq_pair
    for name in ("phi2q", "gphi2q", "tr_tabs", "Mref2"):
        close(getattr(te, name), getattr(je, name), 1e-14)
    np.testing.assert_array_equal(te.fcell_nodes.numpy(),
                                  np.asarray(je.fcell_nodes))
    np.testing.assert_array_equal(te.cnm.numpy(), np.asarray(je.cnm))
    assert te.n_eta == je.n_eta == te.mesh.nv + te.mesh.nf


def test_eta_operators_match_reference(eq_pair):
    """Evaluation, traces, the CG projection of each bucket kind, the
    consistent mass, its PCG inverse and the L2 norm."""
    je, te = eq_pair
    rng = np.random.default_rng(5)
    nc, nf = te.mesh.nc, te.mesh.nf
    nq, nqf = te.phi2q.shape[0], te.tr_tabs.shape[2]
    eta = rng.standard_normal(te.n_eta)
    bc = rng.standard_normal((nc, nq))
    bg = rng.standard_normal((nc, nq, 2))
    bf = rng.standard_normal((nf, 2, nqf))
    a, b = both(eq_pair, lambda e, v: e.eta_cell_values(v), eta)
    close(b, a, 1e-12)
    a, b = both(eq_pair, lambda e, v: e.eta_traces(v), eta)
    close(b, a, 1e-12)
    for buckets in ((bc, bg, bf), (bc, None, None), (None, bg, None),
                    (None, None, bf), (None, bg, bf)):
        a, b = both(eq_pair, lambda e, *x: e.project_eta_buckets(*x),
                    *buckets)
        close(b, a, 1e-12)
    a, b = both(eq_pair, lambda e, v: e.eta_mass_apply(v), eta)
    close(b, a, 1e-12)
    a, b = both(eq_pair, lambda e, v: e.norm_elev(v), eta)
    assert abs(float(b) - float(a)) <= 1e-12 * abs(float(a))


def test_eta_mass_inverse_matches_reference(eq_pair):
    """The 30-iteration PCG on the consistent CG2 mass, preconditioned by
    the mass's diagonal: the reference's loop with its preconditioner
    vector set to that diagonal (its own, the lumped mass, fails: next
    test), to 1e-12; converged."""
    je, te = eq_pair
    r = np.random.default_rng(6).standard_normal(te.n_eta)
    lumped = je._lumped
    try:
        je._lumped = jnp.asarray(te.mass_diag.numpy())
        a = je.eta_mass_inverse(jnp.asarray(r))
    finally:
        je._lumped = lumped
    b = te.mass_inverse_elev(tensor(r))
    close(b, a, 1e-12)
    close(te.eta_mass_apply(b), r, 1e-10)


def test_eta_mass_inverse_is_the_references_name(eq_pair):
    """``eta_mass_inverse``, the reference's name, is the port's
    ``mass_inverse_elev`` (held to the reference above)."""
    _, te = eq_pair
    assert type(te).eta_mass_inverse is type(te).mass_inverse_elev
    r = tensor(np.random.default_rng(6).standard_normal(te.n_eta))
    assert torch.equal(te.eta_mass_inverse(r), te.mass_inverse_elev(r))


def test_cg2_mass_inverse_repairs_the_lumped_pcg(eq_pair):
    """The reference's lumped CG2 mass (``shallowwater_dgcg.py:56-60``) is
    zero at the vertices up to roundoff (a P2 vertex basis function
    integrates to 0 on a triangle), so its PCG starts near ``r / 1e-10``
    and 30 iterations leave an O(1) error.  The port's diagonal
    preconditioner inverts the mass in f64 and in f32 (ROADMAP C)."""
    je, te = eq_pair
    nv = te.mesh.nv
    lumped = np.asarray(je._lumped)
    assert np.abs(lumped[:nv]).max() < 1e-9 * lumped[nv:].min()
    eta = np.random.default_rng(9).standard_normal(te.n_eta)
    r = te.eta_mass_apply(tensor(eta))
    ref = np.asarray(je.eta_mass_inverse(jnp.asarray(r.numpy())))
    assert np.abs(ref - eta).max() > 1e-2
    close(te.mass_inverse_elev(r), eta, 1e-9)
    got32 = te.mass_inverse_elev(r.float())
    assert bool(torch.isfinite(got32).all())
    close(got32.double(), eta, 1e-4)


def test_interior_fluxes_cancel(eq_pair):
    """Antisymmetric interior facet fluxes ([-f, +f] per side) leave only
    the boundary facets in the projected total: the continuity rows of
    a closed basin conserve volume."""
    _, te = eq_pair
    rng = np.random.default_rng(8)
    f = tensor(rng.standard_normal((te.mesh.nf, te.tr_tabs.shape[2])))
    interior = te.mask_int[:, None].to(F64)
    r = te.project_eta_buckets(None, None,
                               torch.stack([-f, f], dim=1) * interior[:, None])
    assert abs(float(r.sum())) <= 1e-13 * float(f.abs().sum())


TERMS = ["ExternalPressureGradientTerm", "HorizontalAdvectionTerm",
         "HorizontalViscosityTerm", "CoriolisTerm", "WindStressTerm",
         "AtmosphericPressureTerm", "QuadraticDragTerm", "LinearDragTerm",
         "BoundaryDragTerm", "MomentumSourceTerm", "HUDivTerm",
         "ContinuitySourceTerm", "all"]


@pytest.mark.parametrize("term", TERMS)
def test_residual_term_matches_reference(eq_pair, term):
    je, te = eq_pair
    assert [n for n, _, _ in te.terms] == [n for n, _, _ in je.terms]
    state, old, fields, bnd = seeded(te)
    label = term if term == "all" else [term]
    a, b = both(eq_pair, lambda e, s, o, f, bv: e.residual(
        label, s, o, f, f, bv), state, old, fields, bnd)
    moved = False
    for k in ("uv", "elev"):
        if np.abs(np.asarray(a[k])).max() > 0:
            moved = True
            close(b[k], a[k], 1e-12)
        else:
            assert float(b[k].abs().max()) == 0.0
    assert moved, term


def test_mass_term_and_inverse_match_reference(eq_pair):
    state, _, _, _ = seeded(eq_pair[1])
    a, b = both(eq_pair, lambda e, s: e.mass_term(s), state)
    for k in ("uv", "elev"):
        close(b[k], a[k], 1e-12)
    # the elevation block's PCG: the two tests above
    a, b = both(eq_pair, lambda e, s: e.mass_inverse(s), state)
    close(b["uv"], a["uv"], 1e-12)


def test_wetting_and_drying_is_refused():
    tm = T.RectangleMesh(4, 2, 1e3, 1e3, device="cpu")
    o = options()
    o.use_wetting_and_drying = True
    with pytest.raises(ValueError, match="dg-dg"):
        TDGCG(tm, TAsm(tm, T.FunctionSpace(tm, "DG", 1)),
              T.FunctionSpace(tm, "CG", 2), o, 10.0)


# -- the model: FlowSolver2d's dg-cg branch -----------------------------------
STEPPERS = {
    "cn_newton": ("CrankNicolson", False),
    "cn_semi": ("CrankNicolson", True),
    "ppp_schur": ("PressureProjectionPicard", None),
}


def reference_solver(stepper, nsteps, dt=10.0):
    """The standing wave of ``tests/test_dgcg.py`` on 16x2 (wave CFL ~6
    at dt 10 s) with an open ``elev`` boundary on marker 2, a Krylov
    budget that solves each step to roundoff; initialized.  ``stepper``
    a key of ``STEPPERS`` or an explicit stepper's name."""
    name, semi = STEPPERS.get(stepper, (stepper, None))
    jm = J.RectangleMesh(NX, NY, LX, LY)
    p1 = J.FunctionSpace(jm, "CG", 1)
    so = J.solver2d.FlowSolver2d(
        jm, J.Function(p1).interpolate(lambda x, y: 100.0 - 0.002 * x))
    o = so.options
    o.element_family = "dg-cg"
    o.timestep = dt
    o.simulation_export_time = dt
    o.simulation_end_time = dt * nsteps
    o.no_exports = True
    o.swe_timestepper_type = name
    so_opts = o.swe_timestepper_options
    if semi is not None:
        so_opts.use_semi_implicit_linearization = semi
    so_opts.solver_parameters = JNP(**TIGHT)
    so.bnd_functions["shallow_water"] = {2: {"elev": J.Constant(0.0)}}
    so.create_function_spaces()
    so.assign_initial_conditions(elev=J.Function(
        so.function_spaces.H_2d).interpolate(
            lambda x, y: 0.5 * np.cos(np.pi * x / LX)))
    return so


def run_states(s):
    out = []
    s.iterate(export_func=lambda: out.append(
        {k: np.array(v) for k, v in s._get_state().items()}))
    return out


@pytest.mark.parametrize("stepper", sorted(STEPPERS))
def test_dgcg_steps_match_reference(stepper):
    """Steps 1 and 3 of the same run in both packages."""
    ref = reference_solver(stepper, 3)
    port = flowsolver2d_from_reference(
        ref, T.RectangleMesh(NX, NY, LX, LY, device="cpu"))
    assert isinstance(port.eq_sw, TDGCG)
    assert tuple(port.fields.elev_2d.data.shape) == (port.eq_sw.n_eta,)
    if stepper == "ppp_schur":
        assert port.timestepper.use_schur_pc
    want, got = run_states(ref), run_states(port)
    assert len(want) == len(got) == 3
    for i in (0, 2):
        for k, v in want[i].items():
            close(got[i][k], v, 1e-10)
    assert np.abs(want[2]["uv"]).max() > 1e-3
    assert port.compute_volume_2d() == pytest.approx(
        ref.compute_volume_2d(), rel=1e-12)


def test_dgcg_explicit_step_records_the_lumped_pcg():
    """An explicit stepper's update is the elevation mass inverse itself,
    so there the reference's lumped CG2 PCG (O(1) off the inverse,
    ROADMAP C) shows in the state: the port's SSPRK33 step matches the
    reference's with its preconditioner set to the port's mass diagonal
    to 1e-10, and parts from the reference's own by more than a tenth of
    the elevation's max."""
    ref = reference_solver("SSPRK33", 1, dt=1.0)
    port = flowsolver2d_from_reference(
        ref, T.RectangleMesh(NX, NY, LX, LY, device="cpu"))
    got = run_states(port)[0]
    lumped = reference_solver("SSPRK33", 1, dt=1.0)
    ref.eq_sw._lumped = jnp.asarray(port.eq_sw.mass_diag.numpy())
    for k, v in run_states(ref)[0].items():
        close(got[k], v, 1e-10)
    want = run_states(lumped)[0]["elev"]
    assert np.abs(got["elev"] - want).max() > 0.1 * np.abs(got["elev"]).max()


# -- the reference test's own cases through the port ------------------------
def port_standing_wave(timesteps, stepper, params=None):
    """``tests/test_dgcg.py::run_standing_wave`` through the port."""
    lx, ly, nx, depth = 5e3, 1e3, 100, 100.0
    g = float(T.physical_constants["g_grav"])
    period = 2 * lx / math.sqrt(g * depth)
    dt = period / timesteps
    mesh2d = T.RectangleMesh(nx, 1, lx, ly, device="cpu")
    p1 = T.FunctionSpace(mesh2d, "CG", 1)
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(p1).assign(depth))
    o = so.options
    o.element_family = "dg-cg"
    o.timestep = dt
    o.simulation_export_time = dt * timesteps
    o.simulation_end_time = period - 0.1 * dt
    o.no_exports = True
    o.swe_timestepper_type = stepper
    if stepper == "CrankNicolson":
        o.swe_timestepper_options.use_semi_implicit_linearization = False
    if params is not None:
        o.swe_timestepper_options.solver_parameters = \
            TNP(**params)
    so.create_function_spaces()
    H2 = so.function_spaces.H_2d
    e0 = T.Function(H2).interpolate(lambda x, y: torch.cos(math.pi * x / lx))
    so.assign_initial_conditions(elev=e0)
    so.iterate()
    return so, float(so.eq_sw.norm_elev(so.fields.elev_2d.data - e0.data)) \
        / math.sqrt(lx * ly)


@pytest.mark.slow
@pytest.mark.parametrize("timesteps,max_rel_err,stepper", [
    (10, 2e-2, "CrankNicolson"),
    (20, 5e-3, "CrankNicolson"),
    (20, 5e-3, "PressureProjectionPicard"),
])
def test_port_dgcg_standing_wave(timesteps, max_rel_err, stepper):
    so, rel = port_standing_wave(timesteps, stepper)
    assert so.iteration == timesteps
    assert rel < max_rel_err, rel


@pytest.mark.slow
def test_port_ppp_schur_bounded_iterations():
    """``test_dgcg.py::test_ppp_schur_bounded_iterations``: one
    30-iteration FGMRES cycle per corrector keeps the wave."""
    so, rel = port_standing_wave(20, "PressureProjectionPicard", dict(
        ksp_rtol=1e-10, ksp_max_it=30, gmres_restart=30))
    assert so.timestepper.use_schur_pc
    assert np.isfinite(rel) and rel < 5e-3, rel


def test_port_dgcg_mass_conservation():
    """``test_dgcg.py::test_dgcg_mass_conservation``: the closed basin's
    volume to 1e-10 over 30 semi-implicit CN steps."""
    lx = 2e3
    mesh2d = T.RectangleMesh(20, 4, lx, lx / 5, device="cpu")
    p1 = T.FunctionSpace(mesh2d, "CG", 1)
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(p1).assign(20.0))
    o = so.options
    o.element_family = "dg-cg"
    o.timestep = 10.0
    o.simulation_export_time = 100.0
    o.simulation_end_time = 300.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    so.create_function_spaces()
    e0 = T.Function(so.function_spaces.H_2d).interpolate(
        lambda x, y: 0.5 * torch.exp(-(((x - lx / 2) / 300.0) ** 2)))
    so.assign_initial_conditions(elev=e0)
    so.initialize()
    v0 = so.compute_volume_2d()
    so.iterate()
    v1 = so.compute_volume_2d()
    assert so.iteration == 30
    assert abs(v1 - v0) / abs(v0) < 1e-10
    assert bool(torch.isfinite(so.fields.elev_2d.data).all())
