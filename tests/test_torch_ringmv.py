"""Ring matvec port: ``ring_mv_reference`` (the plain PyTorch version of
the CUDA kernel in ``thetis_tpu_torch/csrc/ring_mv.cu``) against the
reference's three forms of the same operator: the ring gather
(``ring_apply``), the shift stencil (``ShiftStencil.apply_T``) and the
Pallas kernel ``ring_mv_pallas`` in interpret mode.  f64 on the CPU;
rtol 1e-12 (the forms sum the same products in different orders).

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``ring_mv_reference`` there); here the wrapper must take the
plain version for CPU tensors without counting a launch."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.solvers import assembled as jas  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.solvers import assembled as tas  # noqa: E402
from thetis_tpu_torch.kernels import ringmv  # noqa: E402

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


def test_batched_inverse_matches_gauss_jordan():
    """``torch.linalg.inv`` (pivoted LU) against the reference's pivotless
    Gauss-Jordan on diagonally dominant blocks: roundoff only."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((9, 9, 50)) + 12.0 * np.eye(9)[:, :, None]
    want = jas.batched_inv_small_T(jnp.asarray(A))
    close(tas.batched_inv_small_T(torch.tensor(A)), want, rtol=1e-12)
