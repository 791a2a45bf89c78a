"""The 2D model's solver modules of ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU), from the same seeded numpy inputs: the CG P1
space, colour probing and the assembled operators, the coarse / Schur /
wave preconditioners (one application each), the Newton solve, and the
repaired breakdown guard of the preconditioners' inner GMRES.

Tolerances: index tables and colours exact; CG P1 values 1e-15 (one
gather, no arithmetic); probed blocks rtol 1e-12; one preconditioner
application rtol 1e-10 (fixed Krylov sweeps, iterated roundoff); the
Newton solve rtol 1e-10 with the same iteration count.  Each carries an
atol of the same factor times the array's scale.  The gradient of one
assembled CN step under the Schur fieldsplit (its transpose in the ring
solve's adjoint) is held to ``jax.grad`` of the reference's (1e-10 of
its largest entry; ``test_torch_adjoint_swe.py``'s
:func:`check_assembled_cn_gradient`)."""
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
from thetis_tpu.solvers import assembled as jas  # noqa: E402
from thetis_tpu.solvers import fieldsplit as jfs  # noqa: E402
from thetis_tpu.solvers import schur as jsc  # noqa: E402
from thetis_tpu.solvers import newton as jnw  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS, Function as TFunction)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations as TSWE)
from thetis_tpu_torch.solvers import assembled as tas  # noqa: E402
from thetis_tpu_torch.solvers import fieldsplit as tfs  # noqa: E402
from thetis_tpu_torch.solvers import schur as tsc  # noqa: E402
from thetis_tpu_torch.solvers import newton as tnw  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy, fields_from_numpy)
from test_torch_adjoint_swe import check_assembled_cn_gradient  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LX, LY = 1e4, 5e3
BND = {1: {"elev": 0.0}}  # open on the left, land elsewhere


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


def close_tree(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], rtol)


_CACHE = {}


def make(kind):
    """Both packages' mesh and SWE equation (sloped CG1 bathymetry), a
    seeded state and the matching fields and BC values."""
    if kind in _CACHE:
        return _CACHE[kind]
    if kind == "rect":
        jm = jgen.RectangleMesh(12, 6, LX, LY)
        tm = tgen.RectangleMesh(12, 6, LX, LY, device="cpu", dtype=F64)
        bnd = BND
    else:
        jm = jgen.PeriodicRectangleMesh(12, 6, LX, LY, direction="x")
        tm = tgen.PeriodicRectangleMesh(12, 6, LX, LY, direction="x",
                                        device="cpu", dtype=F64)
        bnd = {}
    bathy = 20.0 + 5.0 * jm.coords_np[:, 1] / LY
    jeq = JSWE(jm, JAsm(jm, JFS(jm, "DG", 1)), opts(), jnp.asarray(bathy),
               bnd_conditions=bnd)
    teq = TSWE(tm, TAsm(tm, TFS(tm, "DG", 1)), opts(),
               torch.tensor(bathy), bnd_conditions=bnd)
    rng = np.random.default_rng(7)
    x = jm.coords_np[jm.cells_np]
    state = {"elev": 0.5 * np.exp(-((x[..., 0] - LX / 2) / 2e3) ** 2),
             "uv": 0.05 * rng.standard_normal((jm.nc, 3, 2))}
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0,
              "quadratic_drag_coefficient": 2.5e-3}
    bvals = {m: {k: 0.0 for k in spec} for m, spec in bnd.items()}
    c = SimpleNamespace(jm=jm, tm=tm, jeq=jeq, teq=teq, state=state,
                        fields=fields, bvals=bvals, rng=rng,
                        hmin=float(jm.cell_hmin_np.min()))
    _CACHE[kind] = c
    return c


def jstate(c, s=None):
    return {k: jnp.asarray(v) for k, v in (s or c.state).items()}


def tstate(c, s=None):
    return state_from_numpy(s or c.state, "cpu", F64)


def jbnd(c):
    return {m: {k: jnp.asarray(v) for k, v in d.items()}
            for m, d in c.bvals.items()}


def tbnd(c):
    return {m: {k: torch.tensor(v, dtype=F64) for k, v in d.items()}
            for m, d in c.bvals.items()}


def rand_state(c, scale=1.0):
    return {"elev": scale * c.rng.standard_normal((c.jm.nc, 3)),
            "uv": scale * c.rng.standard_normal((c.jm.nc, 3, 2))}


# -- CG P1 space ----------------------------------------------------------
@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_cg1_space_and_cell_dofs(kind):
    c = make(kind)
    js, ts = JFS(c.jm, "CG", 1), TFS(c.tm, "CG", 1)
    assert ts.dof_shape() == tuple(js.dof_shape()) == (c.jm.nv,)
    assert ts.node_count == js.node_count and not ts.is_dg
    np.testing.assert_array_equal(ts.cell_node_map.numpy(),
                                  np.asarray(js.cell_node_map))
    close(ts.dof_coords(), js.dof_coords(), 1e-15)
    v = c.rng.standard_normal(c.jm.nv)
    close(ts.cell_dofs(torch.tensor(v)), js.cell_dofs(jnp.asarray(v)), 1e-15)
    vv = c.rng.standard_normal((c.jm.nv, 2))
    close(TFS(c.tm, "CG", 1, dim=2).cell_dofs(torch.tensor(vv)),
          JFS(c.jm, "CG", 1, dim=2).cell_dofs(jnp.asarray(vv)), 1e-15)
    f = TFunction(ts).interpolate(lambda x, y: x + 2 * y)
    close(f.data, c.jm.coords_np[:, 0] + 2 * c.jm.coords_np[:, 1], 1e-15)
    # CG P2 (vertices, then one dof per facet) is the reference's too
    np.testing.assert_array_equal(TFS(c.tm, "CG", 2).cell_node_map.numpy(),
                                  np.asarray(JFS(c.jm, "CG", 2).cell_node_map))
    with pytest.raises(NotImplementedError, match="CG3"):
        TFS(c.tm, "CG", 3)


# -- colour probing and assembled operators -------------------------------
@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_coloring_and_probed_blocks(kind):
    c = make(kind)
    jring, jvalid, jcol = jas.get_coloring(c.jm)
    tring, tvalid, tcol = tas.get_coloring(c.tm)
    np.testing.assert_array_equal(tring, jring)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_array_equal(
        tcol, jas.distance2_coloring(jring, jvalid))
    # distance-2 proper: every closed 1-ring has distinct colours
    rc = tcol[tring]
    for s in range(4):
        for q in range(s + 1, 4):
            live = tvalid[:, s] & tvalid[:, q]
            assert (rc[live, s] != rc[live, q]).all()
    assert tas.get_coloring(c.tm) is tas.get_coloring(c.tm)  # cached

    # a random 1-ring operator, probed through a gather matvec
    nc = c.jm.nc
    B = c.rng.standard_normal((nc, 4, 9, 9)) * jvalid[:, :, None, None]
    n_col = int(jcol.max()) + 1
    jb = jas.assemble_ring_blocks(
        lambda v: jas.ring_apply(jnp.asarray(B), jnp.asarray(jring), v),
        (9,), (9,), jring, jvalid, jcol, n_col, nc, dtype=jnp.float64)
    tb = tas.assemble_ring_blocks(
        lambda v: tas.ring_apply(torch.tensor(B), torch.tensor(tring), v),
        9, 9, tring, tvalid, tcol, n_col, nc, F64, "cpu", chunk_size=5)
    close(tb, jb, 1e-12)
    close(tb, B, 1e-12)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_assemble_affine_operator(kind):
    """The semi-implicit CN system, probed: blocks and F(0) of the
    reference, and the blocks equal the analytic assembly."""
    c = make(kind)
    dt = 4.0 * c.hmin / np.sqrt(9.81 * 25.0)
    jf = {k: jnp.asarray(v) for k, v in c.fields.items()}
    tf = fields_from_numpy(c.fields, "cpu", F64)

    def jF(x):
        lag = jstate(c)
        st = jas.PackedState(lag).unpack(x)
        r = c.jeq.residual("all", st, lag, jf, jf, jbnd(c))
        m = c.jeq.mass_term(st)
        return jas.PackedState(lag).pack(
            {k: m[k] - 0.5 * dt * r[k] for k in m})

    def tF(x):
        lag = tstate(c)
        st = tas.PackedState(lag).unpack(x)
        r = c.teq.residual("all", st, lag, tf, tf, tbnd(c))
        m = c.teq.mass_term(st)
        return tas.PackedState(lag).pack(
            {k: m[k] - 0.5 * dt * r[k] for k in m})

    x0 = jas.PackedState(jstate(c)).pack(jstate(c))
    jb, jf0 = jas.assemble_affine_operator(jF, x0, c.jm)
    tb, tf0 = tas.assemble_affine_operator(tF, torch.tensor(np.asarray(x0)),
                                           c.tm)
    close(tb, jb, 1e-12)
    close(tf0, jf0, 1e-12)
    analytic = c.teq.assemble_operator_blocks(tstate(c), tf, tbnd(c),
                                              0.5 * dt)
    close(tas.cell_to_T(tb), analytic, 1e-11)


# -- preconditioners: one application each --------------------------------
def rest_blocks(c, coeff):
    """Cell-major blocks of the rest-state CN operator (as
    ``FlowSolver2d._build_coarse`` builds them), both packages."""
    out = []
    for pkg, eq, zero, asm_mod, mesh in (
            ("j", c.jeq, {"uv": jnp.zeros((c.jm.nc, 3, 2)),
                          "elev": jnp.zeros((c.jm.nc, 3))}, jas, c.jm),
            ("t", c.teq, {"uv": torch.zeros((c.jm.nc, 3, 2), dtype=F64),
                          "elev": torch.zeros((c.jm.nc, 3), dtype=F64)},
             tas, c.tm)):
        ps = asm_mod.PackedState(zero)
        bz = {m: {k: 0.0 for k in keys} for m, keys in eq.bnd_keys.items()}

        def F(x, eq=eq, ps=ps, zero=zero, bz=bz):
            st = ps.unpack(x)
            r = eq.residual("all", st, zero, {}, {}, bz)
            m = eq.mass_term(st)
            return ps.pack({k: m[k] - coeff * r[k] for k in m})

        out.append(asm_mod.assemble_affine_operator(F, ps.pack(zero),
                                                    mesh)[0])
    return out


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_coarse_correction(kind):
    c = make(kind)
    jb, tb = rest_blocks(c, 6.0 * c.hmin / np.sqrt(9.81 * 25.0))
    ring = jas.get_coloring(c.jm)[0]
    jcc = jas.CoarseCorrection(jb, ring, c.jm, target_size=12)
    tcc = tas.CoarseCorrection(tb, ring, c.tm, target_size=12)
    assert tcc.n_agg == jcc.n_agg
    close(tcc.Ac_inv, jcc.Ac_inv, 1e-10)
    r = c.rng.standard_normal((c.jm.nc, 9))
    close(tcc(torch.tensor(r)), jcc(jnp.asarray(r)), 1e-10)
    # the per-field space (eta, u, v constants per aggregate) against a
    # dense Galerkin product P^T A P
    fields = np.array([0, 0, 0, 1, 2, 1, 2, 1, 2])
    fcc = tas.CoarseCorrection(tb, ring, c.tm, target_size=12,
                               fields=fields)
    nc, agg = c.jm.nc, fcc.agg.numpy()
    A = np.zeros((nc * 9, nc * 9))
    bn = tb.numpy()
    for cell in range(nc):
        for s in range(4):
            n = ring[cell, s]
            A[cell * 9:cell * 9 + 9, n * 9:n * 9 + 9] += bn[cell, s]
    P = np.zeros((nc * 9, fcc.n_agg * 3))
    P[np.arange(nc * 9), (agg[:, None] * 3 + fields[None, :]).ravel()] = 1
    want = P @ np.linalg.solve(P.T @ A @ P, P.T @ r.ravel())
    close(fcc(torch.tensor(r)), want.reshape(nc, 9), 1e-10)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_coarse_restriction_is_a_sorted_segment_sum(kind):
    """The coarse corrections restrict by a segment sum over the cells
    sorted by aggregate (one fixed summation order on every device; a
    CUDA ``index_add_`` sums in the order of its atomics): every cell
    once, in its own aggregate's segment, the sums equal to
    ``np.add.at``'s."""
    c = make(kind)
    agg, n_agg = tas.aggregate_cells(c.tm, 12)
    order, lengths = tas.aggregate_segments(agg, n_agg, c.tm.device)
    nc = c.tm.nc
    assert np.array_equal(np.sort(order.numpy()), np.arange(nc))
    assert int(lengths.sum()) == nc and len(lengths) == n_agg
    ends = np.cumsum(lengths.numpy())
    assert all((agg[order.numpy()[e - n:e]] == a).all()
               for a, (e, n) in enumerate(zip(ends, lengths.numpy())))
    r = c.rng.standard_normal((nc, 9))
    want = np.zeros((n_agg, 9))
    np.add.at(want, agg, r)
    close(tas.restrict(torch.tensor(r), (order, lengths)), want, 1e-14)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_schur_fieldsplit_pc(kind):
    c = make(kind)
    jb, tb = rest_blocks(c, 25.0 * c.hmin / np.sqrt(9.81 * 25.0))
    ring = jas.get_coloring(c.jm)[0]
    jpc = jfs.SchurFieldsplitPC(jb, ring, c.jm, coarse_cap=64)
    tpc = tfs.SchurFieldsplitPC(tb, ring, c.tm, coarse_cap=64)
    assert tpc.is_full_pc and tpc.n_agg == jpc.n_agg
    close(tpc.Sdiag_inv, jpc.Sdiag_inv, 1e-10)
    r = c.rng.standard_normal((c.jm.nc, 9))
    close(tpc(torch.tensor(r)), jpc(jnp.asarray(r)), 1e-10)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_assembled_wave_pc(kind):
    c = make(kind)
    dt = 3.0 * c.hmin / np.sqrt(9.81 * 25.0)
    jzero = {k: jnp.zeros_like(v) for k, v in jstate(c).items()}
    tzero = {k: torch.zeros_like(v) for k, v in tstate(c).items()}
    jpc = jas.AssembledWavePC(c.jeq, dt, 0.5, jzero, inner_iterations=12)
    tpc = tas.AssembledWavePC(c.teq, dt, 0.5, tzero, inner_iterations=12)
    close(tpc.Wb.permute(3, 0, 1, 2), jpc.Wb, 1e-12)
    close(tpc.Wdiag_inv.permute(2, 0, 1), jpc.Wdiag_inv, 1e-11)
    r = rand_state(c)
    close_tree(state_to_numpy(tpc(tstate(c, r))), jpc(jstate(c, r)), 1e-10)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_wave_equation_schur_pc(kind):
    c = make(kind)
    dt = 3.0 * c.hmin / np.sqrt(9.81 * 25.0)
    jf = {k: jnp.asarray(v) for k, v in c.fields.items()}
    tf = fields_from_numpy(c.fields, "cpu", F64)
    jpc = jsc.WaveEquationSchurPC(c.jeq, dt, 0.5, jstate(c), jf, jbnd(c),
                                  inner_iterations=10)
    tpc = tsc.WaveEquationSchurPC(c.teq, dt, 0.5, tstate(c), tf, tbnd(c),
                                  inner_iterations=10)
    r = rand_state(c)
    close_tree(state_to_numpy(tpc(tstate(c, r))), jpc(jstate(c, r)), 1e-10)


# -- the Newton solve -------------------------------------------------------
def cn_residual(eq, u_old, fields, bnd, dt):
    """The (fully implicit) CrankNicolson step residual of either
    package, as ``steppers.CrankNicolson`` builds it."""
    m_old = eq.mass_term(u_old)
    r_old = eq.residual("all", u_old, u_old, fields, fields, bnd)

    def F(u):
        r = eq.residual("all", u, u, fields, fields, bnd)
        m = eq.mass_term(u)
        return {k: m[k] - 0.5 * dt * r[k] - m_old[k] - 0.5 * dt * r_old[k]
                for k in m}
    return F


@pytest.mark.parametrize("line_search", [False, True])
def test_newton_solve_matches_reference(line_search):
    c = make("rect")
    dt = 3.0 * c.hmin / np.sqrt(9.81 * 25.0)
    s = {"elev": c.state["elev"], "uv": 10.0 * c.state["uv"]}  # nonlinear
    jf = {k: jnp.asarray(v) for k, v in c.fields.items()}
    tf = fields_from_numpy(c.fields, "cpu", F64)
    jF = cn_residual(c.jeq, jstate(c, s), jf, jbnd(c), dt)
    tF = cn_residual(c.teq, tstate(c, s), tf, tbnd(c), dt)
    kw = dict(ksp_rtol=1e-10, ksp_max_it=60, gmres_restart=20,
              line_search=line_search)
    stats = {}
    got = tnw.newton_solve(tF, tstate(c, s), precond=c.teq.mass_inverse,
                           params=tnw.NewtonParameters(**kw), stats=stats)
    want = jnw.newton_solve(jF, jstate(c, s), precond=c.jeq.mass_inverse,
                            params=jnw.NewtonParameters(**kw))
    close_tree(state_to_numpy(got), want, 1e-10)
    n = stats["newton_iterations"]
    assert 2 <= n < 8 and stats["snes_rel_residual"] <= 1e-8
    # the reference's iteration count: capped at n it reproduces its own
    # uncapped result exactly, capped at n - 1 it does not
    for cap, same in ((n, True), (n - 1, False)):
        capped = jnw.newton_solve(
            jF, jstate(c, s), precond=c.jeq.mass_inverse,
            params=jnw.NewtonParameters(snes_max_it=cap, **kw))
        equal = all(np.array_equal(np.asarray(capped[k]),
                                   np.asarray(want[k])) for k in want)
        assert equal is same, (cap, n)


def test_dense_and_linear_solve():
    rng = np.random.default_rng(3)
    n = 30
    A = np.eye(n) * 4 + 0.3 * rng.standard_normal((n, n))
    b = {"elev": rng.standard_normal(n)}
    At = torch.tensor(A)
    got = tnw.linear_solve(lambda v: {"elev": At @ v["elev"]},
                           {"elev": torch.tensor(b["elev"])}, rtol=1e-12,
                           restart=30, maxiter=2)
    want = jnw.linear_solve(lambda v: {"elev": jnp.asarray(A) @ v["elev"]},
                            {"elev": jnp.asarray(b["elev"])}, rtol=1e-12,
                            restart=30, maxiter=2)
    close(got["elev"], want["elev"], 1e-10)
    dense = tnw._linsolve(lambda v: {"elev": At @ v["elev"]},
                          {"elev": torch.tensor(b["elev"])}, None,
                          tnw.NewtonParameters(dense=True))
    close(dense["elev"], np.linalg.solve(A, b["elev"]), 1e-12)


# -- the breakdown guard of the preconditioners' inner GMRES --------------
def _rel_res(apply64, z, r):
    z64 = torch.as_tensor(np.asarray(z, dtype=np.float64))
    r64 = torch.as_tensor(np.asarray(r, dtype=np.float64))
    return float((apply64(z64) - r64).norm() / r64.norm())


def test_breakdown_guard_assembled_wave_pc():
    """f32, right-hand side of norm ~1e8 (the residual scale of a
    102,400-cell mesh): the reference's guard (``hj1 > eps * beta``)
    reads every Arnoldi step as a breakdown and the W solve collapses to
    one step; the port's scale-free guard keeps the full sweep and agrees
    with its own f64 solve."""
    c = make("rect")
    dt = 3.0 * c.hmin / np.sqrt(9.81 * 25.0)
    jzero = {k: jnp.zeros_like(v) for k, v in jstate(c).items()}
    tzero = {k: torch.zeros_like(v) for k, v in tstate(c).items()}
    jpc = jas.AssembledWavePC(c.jeq, dt, 0.5, jzero, inner_iterations=12)
    tpc = tas.AssembledWavePC(c.teq, dt, 0.5, tzero, inner_iterations=12)
    nc = c.jm.nc
    r = c.rng.standard_normal((9, nc))
    r *= 1e8 / np.linalg.norm(r)
    Wb64, ring, valid = tpc.Wb, tpc.ring, tpc.valid

    def W64(zT):
        return tas.ring_mv(Wb64, zT.contiguous(), ring, valid)

    # the reference's solve, in f32 throughout (cell-major vectors)
    jpc.Wb = jpc.Wb.astype(jnp.float32)
    jpc.Wdiag_inv = jpc.Wdiag_inv.astype(jnp.float32)
    z_ref = np.asarray(jpc._solve(jnp.asarray(r.T, dtype=jnp.float32))).T
    z64 = tpc._solve(torch.tensor(r))
    tpc.Wb, tpc.Wdiag_inv = Wb64.float(), tpc.Wdiag_inv.float()
    z32 = tpc._solve(torch.tensor(r, dtype=torch.float32))
    res_ref = _rel_res(W64, z_ref, r)
    res_port = _rel_res(W64, z32, r)
    assert res_ref >= 10.0 * res_port, (res_ref, res_port)
    close(z32.double(), z64, 1e-4)


def test_breakdown_guard_schur_fieldsplit():
    """The same fault in ``SchurFieldsplitPC._ssolve``: f32, S-system
    right-hand side of norm ~1e8."""
    c = make("rect")
    jb, tb = rest_blocks(c, 25.0 * c.hmin / np.sqrt(9.81 * 25.0))
    ring = jas.get_coloring(c.jm)[0]
    jpc = jfs.SchurFieldsplitPC(jb, ring, c.jm, coarse_cap=64, s_iters=16)
    t64 = tfs.SchurFieldsplitPC(tb, ring, c.tm, coarse_cap=64, s_iters=16)
    t32 = tfs.SchurFieldsplitPC(tb.float(), ring, c.tm, coarse_cap=64,
                                s_iters=16)
    for name in ("Auu", "Aue", "Aeu", "Aee", "Duu_inv", "Sdiag_inv",
                 "Ac_inv"):
        setattr(jpc, name, getattr(jpc, name).astype(jnp.float32))
    b = c.rng.standard_normal((c.jm.nc, 3))
    b *= 1e8 / np.linalg.norm(b)
    z_ref = np.asarray(jpc._ssolve(jnp.asarray(b, dtype=jnp.float32)))
    z32 = t32._ssolve(torch.tensor(b, dtype=torch.float32))
    z64 = t64._ssolve(torch.tensor(b))
    res_ref = _rel_res(t64._S, z_ref, b)
    res_port = _rel_res(t64._S, z32, b)
    assert res_ref >= 10.0 * res_port, (res_ref, res_port)
    close(z32.double(), z64, 1e-4)


def test_assembled_cn_schur_gradient_matches_reference(monkeypatch):
    check_assembled_cn_gradient("cn_schur", monkeypatch)
