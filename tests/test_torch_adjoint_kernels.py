"""The adjoint's building blocks in ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): the ring matvec's backward
(``kernels/ringmv.py::RingMV``), the wrappers' refusal of a graph, the
ring solve's implicit-function adjoint with the transposed
preconditioners (``solvers/assembled.py``, ``solvers/fieldsplit.py``)
and the mass PCG as a transposable linear solve (``solvers/pcg.py``).

``gradcheck`` holds ``RingMV``'s backward against finite differences on
the ragged cases of ``kernels/cases.py`` (random tables: the backward's
scatter) and on both test meshes' rings (closed tables: the transposed
blocks through the matvec); the VJPs equal ``jax.vjp`` of the
reference's ``ring_apply`` to 1e-12.  ``ring_gmres``'s gradient with
respect to the right-hand side and the warm start, with the coarse
correction and with the Schur fieldsplit, equals ``jax.grad`` of the
reference's ``ring_gmres`` to 1e-10, with respect to the blocks to 1e-8
(both solve to 1e-13 on the same Krylov path; the blocks' cotangent is a
product of the two solves).  The CUDA kernels run only on the card (``chip_smoke.py``
phase 28 holds the backward's launches there)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thetis_tpu.solvers import assembled as jas  # noqa: E402
from thetis_tpu.solvers import fieldsplit as jfs  # noqa: E402
from thetis_tpu_torch.kernels import ringmv  # noqa: E402
from thetis_tpu_torch.kernels.cases import RAGGED_NC, ragged_case  # noqa: E402
from thetis_tpu_torch.solvers import assembled as tas  # noqa: E402
from thetis_tpu_torch.solvers import fieldsplit as tfs  # noqa: E402
from thetis_tpu_torch.solvers.newton import _tangent_map  # noqa: E402
from thetis_tpu_torch.solvers.pcg import JacobiPCG, jacobi_pcg  # noqa: E402
from test_torch_solvers2d import make, rest_blocks  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def ragged_tensors(nc):
    blocks_T, x_T, diag_T, ring, valid = ragged_case(nc)
    return (torch.tensor(blocks_T), torch.tensor(x_T), torch.tensor(diag_T),
            torch.tensor(ring), torch.tensor(valid))


@pytest.mark.parametrize("nc", RAGGED_NC)
def test_ring_mv_function_gradcheck_ragged(nc):
    """Random tables are not closed rings: ``xbar`` is the scatter.  The
    two largest cases in gradcheck's fast mode (one random projection)."""
    blocks_T, x_T, _, ring, valid = ragged_tensors(nc)
    assert ringmv.ring_reverse(ring, valid) is None
    b = blocks_T.clone().requires_grad_(True)
    x = x_T.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda b, x: ringmv.RingMV.apply(b, x, ring, valid), (b, x),
        fast_mode=nc > 64)


def mesh_ring(kind, seed=0):
    c = make(kind)
    ring, valid = tas.ring_tables(c.tm)
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((4, 9, 9, c.tm.nc))
    x = rng.standard_normal((9, c.tm.nc))
    return c, ring, valid, torch.tensor(blocks), torch.tensor(x)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_ring_mv_function_gradcheck_mesh(kind):
    """A mesh's ring is closed: ``xbar`` is one more RingMV on the
    transposed blocks (the kernel's path on the card), and double
    backward works through it."""
    _, ring, valid, blocks, x = mesh_ring(kind)
    assert ringmv.ring_reverse(ring, valid) is not None
    b = blocks.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)

    def f(b, xx):
        return ringmv.RingMV.apply(b, xx, ring, valid)

    assert torch.autograd.gradcheck(f, (b, xx), fast_mode=True)
    assert torch.autograd.gradgradcheck(f, (b, xx), fast_mode=True)


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_ring_mv_vjp_matches_reference(kind):
    """``RingMV``'s VJP against ``jax.vjp`` of the reference's
    ``ring_apply`` on cell-major blocks (invalid slots zeroed, as the
    assemblies make them)."""
    c, ring, valid, blocks, x = mesh_ring(kind, seed=1)
    ring_np, valid_np = tas.cell_ring(c.tm)
    bc = blocks.numpy().transpose(3, 0, 1, 2) * valid_np[:, :, None, None]
    ybar = np.random.default_rng(2).standard_normal((c.tm.nc, 9))
    _, vjp = jax.vjp(lambda b, v: jas.ring_apply(b, jnp.asarray(ring_np), v,
                                                 stencil=None),
                     jnp.asarray(bc), jnp.asarray(x.numpy().T))
    jb, jx = vjp(jnp.asarray(ybar))
    b = torch.tensor(bc.transpose(1, 2, 3, 0).copy(), requires_grad=True)
    xx = x.clone().requires_grad_(True)
    y = ringmv.RingMV.apply(b, xx, ring, valid)
    gb, gx = torch.autograd.grad(y, (b, xx), torch.tensor(ybar.T.copy()))
    close(gx.T, jx)
    # the reference's gather reads the mirror slots' (zero) blocks, so its
    # cotangent there is not zero: compare the valid slots
    mask = valid_np[:, :, None, None]
    close(gb.permute(3, 0, 1, 2), np.asarray(jb) * mask)
    # the block cotangent is zero on the invalid slots, as the forward
    # never reads them
    assert float(gb.permute(3, 0, 1, 2)[~torch.tensor(valid_np)].abs()
                 .max()) == 0.0


@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_ring_transpose_matches_dense_transpose(kind):
    c, ring, valid, blocks, x = mesh_ring(kind, seed=3)
    rev = ringmv.ring_reverse(ring, valid)
    bt = ringmv.ring_transpose_T(blocks, ring, valid, rev)
    nc = c.tm.nc
    dense = np.zeros((9 * nc, 9 * nc))
    Bn, r, v = blocks.numpy(), ring.numpy(), valid.numpy()
    for cell in range(nc):
        for s in range(4):
            if v[cell, s]:
                n = r[cell, s]
                dense[cell * 9:cell * 9 + 9, n * 9:n * 9 + 9] += \
                    Bn[s, :, :, cell]
    y = ringmv.ring_mv_reference(bt, x, ring, valid)
    close(y.T.reshape(-1), dense.T @ x.numpy().T.reshape(-1))


def test_wrappers_refuse_a_graph():
    """A kernel's result has no graph: both wrappers raise on an input
    that requires grad (on the CPU as on the card), and run under
    ``no_grad`` or inside RingMV."""
    blocks_T, x_T, diag_T, ring, valid = ragged_tensors(33)
    b = blocks_T.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ringmv.ring_mv(b, x_T, ring, valid)
    with pytest.raises(RuntimeError, match="requires grad"):
        ringmv.ring_mv(blocks_T, x_T.clone().requires_grad_(True), ring,
                       valid)
    with pytest.raises(RuntimeError, match="requires grad"):
        ringmv.block_diag_mv(diag_T.clone().requires_grad_(True), x_T)
    with pytest.raises(RuntimeError, match="requires grad"):
        ringmv.block_diag_mv(diag_T, x_T.clone().requires_grad_(True))
    with torch.no_grad():
        y = ringmv.ring_mv(b, x_T, ring, valid)
        ringmv.block_diag_mv(diag_T.clone().requires_grad_(True), x_T)
    ringmv.reset_launches()
    y2 = ringmv.RingMV.apply(b, x_T, ring, valid)
    assert y2.requires_grad and torch.equal(y2.detach(), y)
    assert ringmv.launches() == 0  # the CPU takes the plain version


# -- the ring solve's adjoint -------------------------------------------------
def solve_case(kind, which):
    """Both packages' rest-state CN blocks (coarse-correction or Schur
    wave CFL), a preconditioner of each package and seeded vectors."""
    c = make(kind)
    cfl = 4.5 if which == "coarse" else 25.0
    jb, tb = rest_blocks(c, cfl * c.hmin / np.sqrt(9.81 * 25.0))
    ring = jas.get_coloring(c.jm)[0]
    if which == "coarse":
        jpc = jas.CoarseCorrection(jb, ring, c.jm, target_size=12)
        tpc = tas.CoarseCorrection(tb, ring, c.tm, target_size=12)
    else:
        jpc = jfs.SchurFieldsplitPC(jb, ring, c.jm, coarse_cap=64)
        tpc = tfs.SchurFieldsplitPC(tb, ring, c.tm, coarse_cap=64)
    rng = np.random.default_rng(13)
    nc = c.jm.nc
    vecs = [rng.standard_normal((nc, 9)) for _ in range(3)]
    return c, ring, np.asarray(jb), jpc, tpc, vecs


@pytest.mark.parametrize("which", ["coarse", "schur"])
def test_transposed_preconditioners(which):
    """The transposed coarse correction and Schur PC against the
    reference's ``transpose()`` on the same vector; each is cached and
    transposes back to its forward object."""
    c, ring, _, jpc, tpc, (r, _, _) = solve_case("rect", which)
    jt, tt = jpc.transpose(), tpc.transpose()
    assert tpc.transpose() is tt and tt.transpose() is tpc
    close(tt(torch.tensor(r)), jt(jnp.asarray(r)), 1e-10)
    if which == "coarse":
        close(tt.Ac_inv, np.asarray(jpc.Ac_inv).T, 1e-12)


@pytest.mark.parametrize("which", ["coarse", "schur"])
def test_ring_gmres_gradient_matches_reference(which):
    """``ring_gmres`` with a warm start: the gradient of ``w . x`` with
    respect to the blocks, ``b`` and ``x0`` against ``jax.grad`` of the
    reference's (cell layout), both solved to 1e-13."""
    c, ring, jb, jpc, tpc, (b, x0, w) = solve_case("rect", which)
    kw = dict(rtol=1e-10, restart=30, max_cycles=40)
    ring_t, valid_t = tas.ring_tables(c.tm)

    def jfun(blocks, b, x0):
        x = jas.ring_gmres(blocks, jnp.asarray(ring), b, coarse=jpc, x0=x0,
                           **kw)
        return jnp.sum(jnp.asarray(w) * x)

    jv, jg = jax.value_and_grad(jfun, argnums=(0, 1, 2))(
        jnp.asarray(jb), jnp.asarray(b), jnp.asarray(x0))
    tb = torch.tensor(jb, requires_grad=True)
    tbv = torch.tensor(b, requires_grad=True)
    tx0 = torch.tensor(x0, requires_grad=True)
    stats = {}
    x = tas.ring_gmres(tas.cell_to_T(tb), ring_t, valid_t, tbv, x0=tx0,
                       coarse=tpc, stats=stats, **kw)
    tv = (torch.tensor(w) * x).sum()
    grads = torch.autograd.grad(tv, (tb, tbv, tx0))
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-11)
    assert stats["adjoint_ksp_cycles"] >= 1
    # the blocks' cotangent on the valid slots (the reference's gather
    # also reads the mirror slots' zero blocks, the kernel skips them);
    # it is the product -lam x[ring] of two solves, each converged to
    # 1e-13 through the operator's conditioning: 1e-8 of its max
    valid = tas.cell_ring(c.tm)[1][:, :, None, None]
    close(grads[0], np.asarray(jg[0]) * valid, 1e-8)
    assert float(grads[0][~torch.tensor(valid[:, :, 0, 0])].abs().max()) == 0
    close(grads[1], jg[1], 1e-10)
    # x = x0 + A^-1 (b - A x0): the warm start's cotangent w - A^T lam is
    # the adjoint solve's residual, below its tolerance times ||w||, in
    # both packages
    wnorm = np.linalg.norm(w)
    assert np.linalg.norm(np.asarray(jg[2])) < 1e-9 * wnorm
    assert float(torch.linalg.vector_norm(grads[2])) < 1e-9 * wnorm


def test_ring_solve_adjoint_needs_a_transpose():
    c, ring, jb, _, tpc, (b, _, _) = solve_case("rect", "coarse")

    class NoTranspose:
        def __call__(self, r):
            return tpc(r)

    ring_t, valid_t = tas.ring_tables(c.tm)
    tb = torch.tensor(jb, requires_grad=True)
    x = tas.ring_gmres(tas.cell_to_T(tb), ring_t, valid_t, torch.tensor(b),
                       coarse=NoTranspose(), rtol=1e-8, restart=20)
    with pytest.raises(NotImplementedError, match="NoTranspose"):
        x.sum().backward()


# -- the mass PCG as a linear solve -------------------------------------------
def spd_case(n=40, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = torch.tensor(A @ A.T / n + 2.0 * np.eye(n))
    return A, torch.diagonal(A).clone(), rng


def test_jacobi_pcg_is_a_symmetric_solve():
    """Gradient, ``torch.func`` JVP and vmap of the PCG are the same
    solve of the cotangent, the tangent and each batch member (the
    reference's ``custom_linear_solve(symmetric=True)``); the backward's
    own backward too."""
    A, d, rng = spd_case()
    pcg = JacobiPCG(lambda v: A @ v, d, 60)

    def solve(v):
        return jacobi_pcg(lambda u: A @ u, v, d, 60)

    b = torch.tensor(rng.standard_normal(40), requires_grad=True)
    g = torch.tensor(rng.standard_normal(40))
    x = pcg(b)
    close(x, solve(b.detach()).numpy(), 1e-15)
    (gb,) = torch.autograd.grad(x, b, g)
    close(gb, solve(g).numpy(), 1e-15)
    t = torch.tensor(rng.standard_normal(40))
    W = torch.tensor(rng.standard_normal((40, 40)))
    u = b.detach()
    want = solve((1 - torch.tanh(W @ u) ** 2) * (W @ t)).numpy()
    _, jv = torch.func.jvp(lambda v: pcg(torch.tanh(W @ v)), (u,), (t,))
    close(jv, want, 1e-13)
    # the Newton products' reverse-over-reverse J v (double backward
    # through the solve)
    jv2 = _tangent_map(lambda d: {"u": pcg(torch.tanh(W @ d["u"]))},
                       {"u": u})({"u": t})["u"]
    close(jv2, want, 1e-13)
    B = torch.tensor(rng.standard_normal((5, 40)))
    close(torch.func.vmap(pcg)(B),
          torch.stack([solve(bi) for bi in B]).numpy(), 1e-15)
    Y = torch.func.vmap(lambda v: torch.func.jvp(pcg, (b.detach(),),
                                                 (v,))[1])(B)
    close(Y, torch.stack([solve(bi) for bi in B]).numpy(), 1e-15)
    assert pcg.replays == 0 and pcg.eager_cuda == 0  # the CPU runs eagerly
