"""Ring matvec port: ``ring_mv_reference`` (the plain PyTorch version of
the CUDA kernel in ``thetis_tpu_torch/csrc/ring_mv.cu``) against the
reference's three forms of the same operator: the ring gather
(``ring_apply``), the shift stencil (``ShiftStencil.apply_T``) and the
Pallas kernel ``ring_mv_pallas`` in interpret mode.  f64 on the CPU;
rtol 1e-12 (the forms sum the same products in different orders).

Block-Jacobi apply port: ``block_diag_mv`` (plain version of
``csrc/block_diag_mv.cu``) against the reference's einsum
(``solvers/assembled.py:487-488``), its Pallas kernel
``block_diag_mv_pallas`` in interpret mode and a numpy loop; rtol 1e-12.
The f32 FGMRES solve is held to its f64 twin at 1e-4 (ksp_rtol 1e-5 on
both, plus f32 roundoff).

Ragged cases (``thetis_tpu_torch/kernels/cases.py``: cell counts around
the kernels' 32-cell tile, random ring tables with duplicate neighbours,
junk in invalid slots and rows with no valid slot): both plain versions
against the reference's ``ring_apply`` and einsum, f64, rtol 1e-12.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against their plain versions there, on the same ragged cases); here
the wrappers must take the plain version for CPU tensors without
counting a launch."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.solvers import assembled as jas  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.solvers import assembled as tas  # noqa: E402
from thetis_tpu_torch.kernels import ringmv  # noqa: E402
from thetis_tpu_torch.kernels.cases import RAGGED_NC, ragged_case  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

MESHES = {
    "rect": (lambda g, **kw: g.RectangleMesh(8, 4, 1e3, 5e2, **kw)),
    "periodic": (lambda g, **kw: g.PeriodicRectangleMesh(
        6, 5, 1e3, 8e2, direction="x", **kw)),
}


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def setup_case(kind, seed=0):
    jm = MESHES[kind](jgen)
    tm = MESHES[kind](tgen, device="cpu", dtype=torch.float64)
    ring, valid = jas.cell_ring(jm)
    ring_t, valid_t = tas.cell_ring(tm)
    np.testing.assert_array_equal(ring_t, ring)
    np.testing.assert_array_equal(valid_t, valid)
    rng = np.random.default_rng(seed)
    nc = jm.nc
    blocks = rng.standard_normal((nc, 4, 9, 9)) * valid[:, :, None, None]
    x = rng.standard_normal((nc, 9))
    return jm, tm, ring, valid, blocks, x


def port_args(tm, blocks, x):
    ring, valid = tas.ring_tables(tm)
    blocks_T = torch.tensor(np.ascontiguousarray(blocks.transpose(1, 2, 3, 0)))
    return blocks_T, torch.tensor(np.ascontiguousarray(x.T)), ring, valid


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_reference_matches_ring_apply_gather(kind):
    jm, tm, ring, valid, blocks, x = setup_case(kind)
    want = jas.ring_apply(jnp.asarray(blocks), jnp.asarray(ring),
                          jnp.asarray(x), stencil=None)
    y = ringmv.ring_mv_reference(*port_args(tm, blocks, x))
    close(y.T, want)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_reference_matches_shift_stencil(kind):
    jm, tm, ring, valid, blocks, x = setup_case(kind, seed=1)
    stencil = jas.get_stencil(jm)
    assert stencil is not None
    bT = jnp.asarray(blocks.transpose(1, 2, 3, 0))
    want = stencil.apply_T(bT, jnp.asarray(x.T), stencil.corr_blocks_T(bT))
    y = ringmv.ring_mv_reference(*port_args(tm, blocks, x))
    close(y, want)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_reference_matches_pallas_interpret(kind):
    """The Pallas kernel leaves the nonconforming rows to the caller
    (``ShiftStencil.apply_T`` adds them); the CUDA kernel's plain version
    covers them through the ring gather, so the corrections are added to
    the Pallas output before comparing."""
    from thetis_tpu.kernels import ringmv as jrm

    jm, tm, ring, valid, blocks, x = setup_case(kind, seed=2)
    stencil = jas.get_stencil(jm)
    bT = jnp.asarray(blocks.transpose(1, 2, 3, 0))
    xT = jnp.asarray(x.T)
    old = jrm._INTERPRET
    jrm._INTERPRET = True
    try:
        yp = jrm.ring_mv_pallas(stencil, bT, xT)
    finally:
        jrm._INTERPRET = old
    assert yp is not None
    if stencil.n_corr:
        cb = stencil.corr_blocks_T(bT)
        contrib = jnp.einsum("kij,jk->ik", cb, xT[:, stencil.corr_srcs])
        yp = yp.at[:, stencil.corr_rows].add(contrib)
    y = ringmv.ring_mv_reference(*port_args(tm, blocks, x))
    close(y, yp)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_cpu_dispatch_takes_plain_version(kind):
    jm, tm, ring, valid, blocks, x = setup_case(kind, seed=3)
    args = port_args(tm, blocks, x)
    ringmv.reset_launches()
    y = ringmv.ring_mv(*args)
    assert ringmv.launches() == 0
    assert torch.equal(y, ringmv.ring_mv_reference(*args))


def test_invalid_slots_are_skipped():
    """A boundary-mirror slot points back at the cell itself; its block is
    ignored even when nonzero, as the stencil's masks do."""
    jm, tm, ring, valid, blocks, x = setup_case("rect", seed=4)
    assert not valid.all()
    dirty = blocks + 1e3 * (~valid)[:, :, None, None]
    y_clean = ringmv.ring_mv(*port_args(tm, blocks, x))
    y_dirty = ringmv.ring_mv(*port_args(tm, dirty, x))
    assert torch.equal(y_clean, y_dirty)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_ring_apply_forms(kind):
    jm, tm, ring, valid, blocks, x = setup_case(kind, seed=5)
    stencil = jas.get_stencil(jm)
    want = jas.ring_apply(jnp.asarray(blocks), jnp.asarray(ring),
                          jnp.asarray(x), stencil=None)
    bT, _, ring_t, valid_t = port_args(tm, blocks, x)
    close(tas.ring_apply(torch.tensor(blocks), ring_t, torch.tensor(x)),
          want)
    want_T = jas.ring_apply_T(jnp.asarray(blocks.transpose(1, 2, 3, 0)),
                              jnp.asarray(x), stencil)
    close(tas.ring_apply_T(bT, torch.tensor(x), ring_t, valid_t), want_T)


@pytest.mark.parametrize("bad", ["dtype", "x_dtype", "d", "ns", "ring_dtype",
                                 "valid_dtype", "noncontig", "x_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    jm, tm, ring, valid, blocks, x = setup_case("rect", seed=6)
    bT, xT, ring_t, valid_t = port_args(tm, blocks, x)
    if bad == "dtype":
        bT = bT.to(torch.float16)
    elif bad == "x_dtype":
        xT = xT.float()
    elif bad == "d":
        bT = bT[:, :3, :3].contiguous()
    elif bad == "ns":
        bT = bT[:3].contiguous()
    elif bad == "ring_dtype":
        ring_t = ring_t.long()
    elif bad == "valid_dtype":
        valid_t = valid_t.to(torch.uint8)
    elif bad == "noncontig":
        xT = torch.tensor(x).T
    elif bad == "x_shape":
        xT = xT[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        ringmv.ring_mv(bT, xT, ring_t, valid_t)


def ragged_args(nc):
    blocks_T, x_T, diag_T, ring, valid = ragged_case(nc, seed=nc)
    return blocks_T, x_T, diag_T, ring, valid, tuple(
        torch.tensor(a) for a in (blocks_T, x_T, ring, valid))


@pytest.mark.parametrize("nc", RAGGED_NC)
def test_ragged_cases_cover_the_edges(nc):
    """Each case of the list that ``chip_smoke.py`` also runs on the card
    has a duplicate neighbour, junk in its invalid slots and, past one
    cell, rows with no valid slot (the last cell's among them)."""
    blocks_T, x_T, diag_T, ring, valid, _ = ragged_args(nc)
    assert ring.dtype == np.int32 and ring.min() >= 0 and ring.max() < nc
    assert (ring[:, 0] == np.arange(nc)).all()
    assert ((ring[:, 1] == ring[:, 2]) & valid[:, 1] & valid[:, 2]).any()
    assert (~valid).any()
    junk = blocks_T.transpose(3, 0, 1, 2)[~valid]      # (n_invalid, 9, 9)
    assert (np.abs(junk).max(axis=(1, 2)) > 0).all()
    if nc > 1:
        assert not valid[-1].any()
    assert nc % 32 != 0


@pytest.mark.parametrize("nc", RAGGED_NC)
def test_ragged_ring_mv_matches_ring_apply(nc):
    """The plain version against the reference's ring gather on random
    ring tables: duplicate neighbours summed, invalid slots skipped even
    with nonzero blocks (the reference's operator carries zero blocks
    there), rows with no valid slot zero; the CPU wrapper takes the plain
    version and counts no launch."""
    blocks_T, x_T, _, ring, valid, args = ragged_args(nc)
    jb = (blocks_T * valid.T[:, None, None, :]).transpose(3, 0, 1, 2)
    want = jas.ring_apply(jnp.asarray(jb), jnp.asarray(ring),
                          jnp.asarray(x_T.T), stencil=None)
    got = ringmv.ring_mv_reference(*args)
    close(got.T, want)
    ringmv.reset_launches()
    assert torch.equal(ringmv.ring_mv(*args), got)
    assert ringmv.launches() == 0
    dead = ~valid.any(axis=1)
    assert (dead.any() or nc == 1) and bool((got[:, dead] == 0).all())


@pytest.mark.parametrize("nc", RAGGED_NC)
def test_ragged_block_diag_mv_matches_reference_einsum(nc):
    _, x_T, diag_T, _, _, _ = ragged_args(nc)
    want = jnp.einsum("ijc,jc->ic", jnp.asarray(diag_T), jnp.asarray(x_T))
    d, r = torch.tensor(diag_T), torch.tensor(x_T)
    got = ringmv.block_diag_mv_reference(d, r)
    close(got, want)
    ringmv.reset_launches()
    assert torch.equal(ringmv.block_diag_mv(d, r), got)
    assert ringmv.launches("block_diag_mv") == 0


def test_batched_inverse_matches_gauss_jordan():
    """``torch.linalg.inv`` (pivoted LU) against the reference's pivotless
    Gauss-Jordan on diagonally dominant blocks: roundoff only."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((9, 9, 50)) + 12.0 * np.eye(9)[:, :, None]
    want = jas.batched_inv_small_T(jnp.asarray(A))
    close(tas.batched_inv_small_T(torch.tensor(A)), want, rtol=1e-12)


def test_batch_leading_inverse_matches_gauss_jordan():
    """``batched_inv_small``, the reference's (n, d, d) layout."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((40, 6, 6)) + 8.0 * np.eye(6)
    want = jas.batched_inv_small(jnp.asarray(A))
    close(tas.batched_inv_small(torch.tensor(A)), want, rtol=1e-12)


def bjac_case(nc, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((9, 9, nc)), rng.standard_normal((9, nc))


@pytest.mark.parametrize("nc", [1, 37, 300])
def test_block_diag_mv_matches_reference_einsum_and_loop(nc):
    diag, r = bjac_case(nc, seed=nc)
    want = jnp.einsum("ijc,jc->ic", jnp.asarray(diag), jnp.asarray(r))
    ringmv.reset_launches()
    got = ringmv.block_diag_mv(torch.tensor(diag), torch.tensor(r))
    assert ringmv.launches("block_diag_mv") == 0
    close(got, want)
    loop = np.stack([diag[:, :, c] @ r[:, c] for c in range(nc)], axis=1)
    close(got, loop)


def test_block_diag_mv_matches_pallas_interpret():
    from thetis_tpu.kernels import ringmv as jrm

    diag, r = bjac_case(50, seed=9)
    old = jrm._INTERPRET
    jrm._INTERPRET = True
    try:
        want = jrm.block_diag_mv_pallas(jnp.asarray(diag), jnp.asarray(r))
    finally:
        jrm._INTERPRET = old
    assert want is not None
    close(ringmv.block_diag_mv(torch.tensor(diag), torch.tensor(r)), want)


def test_ring_solve_preconditions_through_block_diag_mv(monkeypatch):
    """The FGMRES block-Jacobi goes through ``block_diag_mv`` (the kernel
    on the card): count its calls in one ring solve."""
    from thetis_tpu_torch.solvers import assembled as tas_mod

    jm, tm, ring, valid, blocks, x = setup_case("periodic", seed=10)
    blocks = blocks + 20.0 * np.eye(9)[None, None] * (
        np.arange(4) == 0)[None, :, None, None]
    bT, xT, ring_t, valid_t = port_args(tm, blocks, x)
    calls = []
    real = tas_mod.block_diag_mv

    def spy(d, v):
        calls.append(v.shape)
        return real(d, v)

    monkeypatch.setattr(tas_mod, "block_diag_mv", spy)
    b = torch.tensor(x)
    got = tas.ring_gmres(bT, ring_t, valid_t, b, torch.zeros_like(b), b,
                         rtol=1e-10, restart=10, max_cycles=5)
    assert calls and all(c == (9, tm.nc) for c in calls)
    close(tas.ring_apply_T(bT, got, ring_t, valid_t), x, rtol=1e-8)


@pytest.mark.parametrize("bad", ["dtype", "r_dtype", "d", "nc", "noncontig"])
def test_block_diag_mv_rejects_bad_inputs(bad):
    diag, r = (torch.tensor(a) for a in bjac_case(20, seed=12))
    if bad == "dtype":
        diag, r = diag.to(torch.float16), r.to(torch.float16)
    elif bad == "r_dtype":
        r = r.float()
    elif bad == "d":
        diag, r = diag[:3, :3].contiguous(), r[:3].contiguous()
    elif bad == "nc":
        r = r[:, :-1].contiguous()
    elif bad == "noncontig":
        r = torch.tensor(np.ascontiguousarray(
            bjac_case(20, seed=12)[1].T)).T
    with pytest.raises((TypeError, ValueError)):
        ringmv.block_diag_mv(diag, r)


def test_fgmres_f32_converges_at_large_residual_scale():
    """The breakdown guard is scale-free: an f32 solve whose residual norm
    is ~1e8 (the 3D bench's barotropic system) still converges.  The
    reference's guard (new Arnoldi norm against eps * beta) reads every
    Arnoldi step of such a solve as a breakdown in f32; in f64 both guards
    take the same path (the CN parity tests)."""
    jm, tm, ring, valid, blocks, x = setup_case("periodic", seed=13)
    blocks = 0.1 * blocks + 5.0 * np.eye(9)[None, None] * (
        np.arange(4) == 0)[None, :, None, None]
    bT, _, ring_t, valid_t = port_args(tm, blocks, x)
    b = torch.tensor(x) * 1e8
    sols = {}
    for dt in (torch.float64, torch.float32):
        bb = b.to(dt)
        sols[dt] = tas.ring_gmres(bT.to(dt), ring_t, valid_t, bb,
                                  torch.zeros_like(bb), bb, rtol=1e-5,
                                  restart=6, max_cycles=8)
    res = (tas.ring_apply_T(bT, sols[torch.float32].double(), ring_t,
                            valid_t) - b).norm() / b.norm()
    assert float(res) < 1e-4
    close(sols[torch.float32].double(), sols[torch.float64], rtol=1e-4)
