"""The non-hydrostatic pressure of ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): the CG P2 space (node count, cell node map and
dof coordinates on a rectangle and on periodic meshes), the Dirichlet
dofs of the Poisson solve, one Poisson solve (q, uv, w) at
``q_solver_rtol`` 1e-12, the free-surface equation's residual, one model
step and the lake at rest, the carrying of the NH options and state
across ``interop``, and the reference tests' own bounds through the port.

Tolerances: the space exactly; the free-surface residual 1e-12 of its
max; the Poisson solve 1e-9 of each output's max (both BiCGStab
iterations stop at 1e-12 of ||b||, on sums in other orders); model steps
1e-9 of each field's max."""
import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402
import thetis_tpu as J  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.nh import bicgstab  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
TIGHT = dict(ksp_rtol=1e-12, ksp_max_it=480, gmres_restart=48)
RTOL = 1e-9


def tensor(v):
    return torch.as_tensor(np.asarray(v), dtype=F64)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


MESHES = {
    "rect": lambda g, **kw: g.RectangleMesh(7, 5, 70.0, 40.0, **kw),
    "periodic_x": lambda g, **kw: g.PeriodicRectangleMesh(
        6, 4, 60.0, 40.0, direction="x", **kw),
    "periodic_both": lambda g, **kw: g.PeriodicRectangleMesh(
        5, 6, 50.0, 60.0, direction="both", **kw),
}


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_cg2_space_matches_reference(kind):
    """Vertices first, then one dof per facet at ``nv + facet``; P2 dof
    coordinates at the (period-unwrapped) facet midpoints."""
    jm = MESHES[kind](jgen)
    tm = MESHES[kind](tgen, device="cpu", dtype=F64)
    a, b = JFS(jm, "CG", 2), TFS(tm, "CG", 2)
    assert b.node_count == a.node_count == tm.nv + tm.nf
    np.testing.assert_array_equal(b.cell_node_map_np, a.cell_node_map_np)
    np.testing.assert_array_equal(b.cell_node_map.numpy(),
                                  np.asarray(a.cell_node_map))
    np.testing.assert_array_equal(b.dof_coords().numpy(),
                                  np.asarray(a.dof_coords()))
    assert tuple(b.zero_dofs().shape) == (a.node_count,)
    f = T.Function(b).interpolate(lambda x, y: x + 2 * y)
    assert tuple(f.data.shape) == (a.node_count,)


def nh_reference(nsteps=1, rtol=1e-12, elev_bc=True, semi=False):
    """A standing wave of ``test_nh.py`` (20x1 over one wavelength, depth
    8 m) with an open ``elev`` boundary on marker 2, the Newton CN and
    ``q_solver_rtol`` ``rtol``; initialized."""
    lx, ly, depth, amp = 20.0, 4.0, 8.0, 0.1
    jm = J.RectangleMesh(20, 1, lx, ly)
    p1 = J.FunctionSpace(jm, "CG", 1)
    so = J.solver2d.FlowSolver2d(jm, J.Function(p1).assign(depth))
    o = so.options
    o.timestep = 0.3
    o.simulation_export_time = 0.3
    o.simulation_end_time = 0.3 * nsteps
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = semi
    o.swe_timestepper_options.solver_parameters = JNP(**TIGHT)
    nho = o.nh_model_options
    nho.solve_nonhydrostatic_pressure = True
    nho.q_solver_rtol = rtol
    nho.q_solver_maxiter = 400
    if elev_bc:
        so.bnd_functions["shallow_water"] = {2: {"elev": J.Constant(0.0)}}
    so.assign_initial_conditions(elev=J.Function(p1).interpolate(
        lambda x, y: amp * np.cos(2 * np.pi * x / lx)))
    return so


@pytest.fixture(scope="module")
def nh_pair():
    ref = nh_reference()
    return ref, flowsolver2d_from_reference(
        ref, T.RectangleMesh(20, 1, 20.0, 4.0, device="cpu"))


def test_dirichlet_dofs_match_reference(nh_pair):
    """q = 0 on the open boundary's vertex and facet dofs."""
    ref, port = nh_pair
    want = np.asarray(ref.poisson_solver.dirichlet)
    np.testing.assert_array_equal(port.poisson_solver.dirichlet.numpy(),
                                  want)
    assert want[:port.mesh2d.nv].sum() == 2 and want[port.mesh2d.nv:].sum() \
        == 1


def poisson_inputs(nc, nv):
    rng = np.random.default_rng(12)
    return dict(uv=0.2 * rng.standard_normal((nc, 3, 2)),
                w=0.01 * rng.standard_normal((nc, 3)),
                elev=0.1 * rng.standard_normal((nc, 3)),
                bathy=8.0 + 0.5 * rng.standard_normal(nv))


def test_poisson_solve_matches_reference(nh_pair):
    """One Poisson solve on a seeded state (a sloped bed) at rtol 1e-12:
    q, the corrected uv and w."""
    ref, port = nh_pair
    d = poisson_inputs(port.mesh2d.nc, port.mesh2d.nv)
    want = ref.poisson_solver.solve(
        jnp.asarray(d["uv"]), jnp.asarray(d["w"]), jnp.asarray(d["elev"]),
        jnp.asarray(d["bathy"]))
    got = port.poisson_solver.solve(tensor(d["uv"]), tensor(d["w"]),
                                    tensor(d["elev"]), tensor(d["bathy"]))
    for g, w in zip(got, want):
        close(g, w, RTOL)
    assert 0 < port.poisson_solver.iterations <= 400


def test_bicgstab_matches_scipy():
    """The BiCGStab on a nonsymmetric system: its solution to the stop
    test, ``||r|| <= tol ||b||``, and the zero right-hand side's 0
    iterations."""
    rng = np.random.default_rng(1)
    n = 40
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3
    b = rng.standard_normal(n)
    At, bt = tensor(A), tensor(b)
    x, k = bicgstab(lambda v: At @ v, bt, torch.zeros_like(bt), tol=1e-10,
                    atol=0.0, maxiter=200, M=lambda v: v / At.diagonal())
    assert 0 < k < 200
    assert float(torch.linalg.norm(bt - At @ x)) <= 1e-10 * float(
        torch.linalg.norm(bt))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-8)
    _, k0 = bicgstab(lambda v: At @ v, torch.zeros_like(bt),
                     torch.zeros_like(bt), tol=1e-10, atol=0.0,
                     maxiter=200, M=lambda v: v)
    assert k0 == 0


def test_free_surface_residual_matches_reference(nh_pair):
    ref, port = nh_pair
    d = poisson_inputs(port.mesh2d.nc, port.mesh2d.nv)
    out = []
    for s, arr in ((ref, jnp.asarray), (port, tensor)):
        f = {"uv_2d": arr(d["uv"])}
        r = s.eq_free_surface.residual(
            "all", {"elev": arr(d["elev"])}, {"elev": arr(d["elev"])}, f, f,
            s._gather_bnd("shallow_water"))
        out.append(r["elev"])
    close(out[1], out[0], 1e-12)


def run_states(s, n):
    out = []
    s.iterate(export_func=lambda: out.append(
        {k: np.array(v) for k, v in s._get_state().items()}))
    return out[-n:]


@pytest.mark.parametrize("semi", [False, True])
def test_nh_steps_match_reference(semi):
    """Two steps through ``iterate()`` (the first with q0 = 0, the second
    warm-started from it): the Newton CN and the semi-implicit CN."""
    ref = nh_reference(nsteps=2, semi=semi)
    port = flowsolver2d_from_reference(
        ref, T.RectangleMesh(20, 1, 20.0, 4.0, device="cpu"))
    assert sorted(port._get_state()) == ["elev", "q", "uv", "w"]
    want, got = run_states(ref, 2), run_states(port, 2)
    for i in (0, 1):
        for k, v in want[i].items():
            close(got[i][k], v, RTOL)
    assert np.abs(want[1]["q"]).max() > 1.0


def test_lake_at_rest_matches_reference():
    """``test_nh.py::test_nh_lake_at_rest``'s case (16x1, 10 steps) in
    both packages: the same rest to roundoff."""
    out = []
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        mesh2d = pkg.RectangleMesh(16, 1, 1e3, 62.5, **kw)
        so = lake_at_rest(pkg, mesh2d)
        so.iterate()
        out.append({k: np.array(v) for k, v in so._get_state().items()})
    for k in ("elev", "q", "uv", "w"):
        assert np.abs(out[1][k] - out[0][k]).max() < 1e-12, k


def test_interop_carries_nh(nh_pair):
    ref, port = nh_pair
    assert vars(port.options.nh_model_options) == \
        vars(ref.options.nh_model_options)
    assert port.fields.q_2d.function_space.degree == 2
    assert tuple(port.fields.q_2d.data.shape) == (port.mesh2d.nv
                                                  + port.mesh2d.nf,)
    assert tuple(port.fields.w_2d.data.shape) == (port.mesh2d.nc, 3)
    assert port.fs_stepper.semi_implicit


# -- the reference tests through the port --------------------------------------
def lake_at_rest(pkg, mesh2d):
    p1 = pkg.FunctionSpace(mesh2d, "CG", 1)
    so = pkg.solver2d.FlowSolver2d(
        mesh2d, pkg.Function(p1, name="bathymetry").assign(50.0))
    o = so.options
    o.timestep = 10.0
    o.simulation_export_time = 100.0
    o.simulation_end_time = 100.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.nh_model_options.solve_nonhydrostatic_pressure = True
    so.assign_initial_conditions()
    return so


def test_port_nh_lake_at_rest():
    so = lake_at_rest(T, T.RectangleMesh(16, 1, 1e3, 62.5, device="cpu"))
    so.iterate()
    assert so.iteration == 10
    assert float(so.fields.elev_2d.data.abs().max()) < 1e-8
    assert float(so.fields.q_2d.data.abs().max()) < 1e-4
    assert float(so.fields.w_2d.data.abs().max()) < 1e-8


@pytest.mark.parametrize("timesteps,max_rel_err", [
    (10, 1.6e-2), (20, 4e-3), (40, 1e-3)])
def test_port_nh_standing_wave(timesteps, max_rel_err):
    """``test_nh.py::test_nh_standing_wave`` through the port, at the
    reference's caps."""
    lx, ly, nx = 20.0, 4.0, 20
    depth, amp = 8.0, 0.1
    g = float(T.physical_constants["g_grav"])
    c = math.sqrt(g * lx / (2 * math.pi) * math.tanh(2 * math.pi * depth
                                                      / lx))
    period = lx / c
    dt = period / timesteps
    mesh2d = T.RectangleMesh(nx, 1, lx, ly, device="cpu")
    p1 = T.FunctionSpace(mesh2d, "CG", 1)
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(p1).assign(depth))
    o = so.options
    o.timestep = dt
    o.simulation_export_time = period
    o.simulation_end_time = period - 0.01 * dt
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = False
    o.nh_model_options.solve_nonhydrostatic_pressure = True
    elev0 = T.Function(p1).interpolate(
        lambda x, y: amp * torch.cos(2 * np.pi * x / lx))
    so.assign_initial_conditions(elev=elev0)
    so.iterate()
    omega = math.sqrt(2 * math.pi * g / lx * math.tanh(2 * math.pi * depth
                                                        / lx))
    anal = T.Function(so.function_spaces.H_2d).interpolate(
        lambda x, y: amp * torch.cos(2 * np.pi * x / lx)
        * math.cos(omega * period))
    rel = float(so.asm.norm_l2(so.fields.elev_2d.data - anal.data)) \
        / math.sqrt(lx * ly)
    assert so.iteration == timesteps
    assert rel < max_rel_err, rel
    q = so.fields.q_2d.data
    w = so.fields.w_2d.data
    assert bool(torch.isfinite(q).all()) and float(q.abs().max()) > 1.0
    assert bool(torch.isfinite(w).all()) and float(w.abs().max()) > 1e-4
