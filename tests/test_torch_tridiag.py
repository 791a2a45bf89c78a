"""Tridiagonal column solve port: ``tridiag_solve`` of
``thetis_tpu_torch/kernels/tridiag.py`` (on CPU tensors its plain version,
the Python-loop Thomas recurrence beside the CUDA kernel
``csrc/tridiag.cu``) against the reference's ``tridiag_solve`` (on the
CPU its ``_thomas_scan``) and against dense numpy solves.  f64; rtol
1e-12 against the reference (the same recurrence, operation for
operation) and 1e-10 on the dense residual (the reference's own bound in
``tests/test_kernels.py``); the f32 plain version against f64 at 1e-5
(f32 roundoff on a well-conditioned system).

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against ``tridiag_reference`` there); here the wrapper must take the
plain version for CPU tensors without counting a launch.  What the wrapper
decides for the card in plain Python is held here: whether the operands
can be read as they are (coefficients shared by several right-hand sides)
and the tiled kernel's launch geometry against the card's limits."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.kernels import tridiag_solve as j_solve  # noqa: E402
from thetis_tpu_torch.kernels import tridiag  # noqa: E402
from thetis_tpu_torch.kernels.cases import (RAGGED_TRIDIAG,  # noqa: E402
                                            ragged_tridiag_case)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

NC3, NZ3 = 4608, 12  # the 3D bench's columns and layers


def system(shapes, n, seed, scale=0.3):
    """Diagonally dominant operands of the given (broadcastable) batch
    shapes: ``shapes`` = (dl, dd, du, rhs) leading shapes."""
    rng = np.random.default_rng(seed)
    dl = rng.normal(size=shapes[0] + (n,)) * scale
    dd = 2.0 + rng.random(shapes[1] + (n,))
    du = rng.normal(size=shapes[2] + (n,)) * scale
    rhs = rng.normal(size=shapes[3] + (n,))
    return dl, dd, du, rhs


def solve_both(ops):
    want = np.asarray(j_solve(*(jnp.asarray(o) for o in ops)))
    tridiag.reset_launches()
    got = tridiag.tridiag_solve(*(torch.tensor(o) for o in ops)).numpy()
    assert tridiag.launches() == 0  # CPU tensors take the plain version
    return got, want


def dense_residual(ops, x):
    dl, dd, du, rhs = (np.broadcast_to(o, x.shape) for o in ops)
    worst = 0.0
    for i in np.ndindex(*x.shape[:-1]):
        A = (np.diag(dd[i]) + np.diag(dl[i][1:], -1)
             + np.diag(du[i][:-1], 1))
        worst = max(worst, np.abs(A @ x[i] - rhs[i]).max())
    return worst


@pytest.mark.parametrize("n", [1, 2, 13, 300])
def test_matches_reference_and_dense(n):
    """The reference's ``test_tridiag_matches_dense`` case (batch (5, 7),
    n = 13) and the extents the port must take: a single row, the bench's
    nz + 1 = 13 and n = 300 beyond the reference's Pallas unroll bound."""
    ops = system([(5, 7)] * 4, n, seed=n)
    got, want = solve_both(ops)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert dense_residual(ops, got) < 1e-10


def test_package_exports_the_solve():
    """``thetis_tpu_torch.kernels.tridiag_solve``, as the reference's
    ``thetis_tpu.kernels`` exports it."""
    from thetis_tpu_torch.kernels import tridiag_solve
    assert tridiag_solve is tridiag.tridiag_solve
    ops = system([(3,)] * 4, 13, seed=4)
    np.testing.assert_allclose(
        tridiag_solve(*(torch.tensor(o) for o in ops)).numpy(),
        np.asarray(j_solve(*(jnp.asarray(o) for o in ops))), rtol=1e-12)


@pytest.mark.parametrize("case", ["rhs_lead", "coeff_lead", "mixed"])
def test_broadcast_batch_axes(case):
    """Operands broadcast over the leading axes, as
    ``vertical_viscosity_implicit`` sends (nc, 3, n) coefficients against a
    (2, nc, 3, n) right-hand side."""
    shapes = {
        "rhs_lead": [(4,), (4,), (4,), (2, 4)],  # reference test_kernels
        "coeff_lead": [(2, 6, 3), (6, 3), (6, 3), (6, 3)],
        "mixed": [(1, 6, 3), (2, 1, 3), (6, 1), (2, 6, 3)],
    }[case]
    ops = system(shapes, 13, seed=7)
    got, want = solve_both(ops)
    assert got.shape == want.shape == np.broadcast_shapes(
        *(o.shape for o in ops))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert dense_residual(ops, got) < 1e-10


def test_reference_recurrence_on_vertical_diffusion_system():
    """The system the 3D step builds (``vdiff_implicit``): -a, 1 + a + c,
    -c with the first/last off-diagonals zero; the column sum of the
    solution equals that of the rhs weighted by the finite volumes."""
    rng = np.random.default_rng(3)
    n = 13
    g = rng.random((10, n - 1)) * 5.0
    V = 0.5 + rng.random((10, n))
    a = np.concatenate([np.zeros((10, 1)), g], axis=1) / V
    c = np.concatenate([g, np.zeros((10, 1))], axis=1) / V
    ops = (-a, 1.0 + a + c, -c, rng.normal(size=(10, n)))
    got, want = solve_both(ops)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # conservation: sum V x == sum V rhs
    np.testing.assert_allclose((V * got).sum(-1), (V * ops[3]).sum(-1),
                               rtol=1e-12)


def test_float32_plain_version():
    ops = system([(50,)] * 4, 13, seed=11)
    x64 = tridiag.tridiag_solve(*(torch.tensor(o) for o in ops))
    x32 = tridiag.tridiag_solve(*(torch.tensor(o, dtype=torch.float32)
                                  for o in ops))
    assert x32.dtype == torch.float32
    np.testing.assert_allclose(x32.numpy(), x64.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "empty",
                                 "scalar", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    dl, dd, du, rhs = (torch.tensor(o) for o in system([(4,)] * 4, 5, 0))
    if bad == "dtype":
        dl, dd, du, rhs = (t.to(torch.float16) for t in (dl, dd, du, rhs))
    elif bad == "mixed_dtype":
        rhs = rhs.float()
    elif bad == "shape":
        rhs = torch.zeros(3, 5, dtype=torch.float64)
    elif bad == "empty":
        dl, dd, du, rhs = (t[:, :0] for t in (dl, dd, du, rhs))
    elif bad == "scalar":
        dd = torch.tensor(2.0, dtype=torch.float64)
    elif bad == "device":
        rhs = rhs.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tridiag.tridiag_solve(dl, dd, du, rhs)


def form(ops):
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    return tridiag.shared_form(*ops, shape)


@pytest.mark.parametrize("lead", [(), (1,), (2,), (3,), (2, 5)])
def test_shared_form_taken_for_shared_coefficients(lead):
    """Coefficients (bc, n) against a right-hand side (R, bc, n), R = 1, 2,
    3, none at all and two leading axes: read as given, R right-hand sides
    a column."""
    dl, dd, du = (torch.zeros(6, 13, dtype=torch.float64) for _ in range(3))
    rhs = torch.zeros(lead + (6, 13), dtype=torch.float64)
    assert form((dl, dd, du, rhs)) == int(np.prod(lead, dtype=int))


def test_shared_form_taken_for_the_velocity_solve():
    """The shapes ``vertical_viscosity_implicit`` sends at the bench's
    size: coefficients (nc, 3, nz + 1), right-hand side (2, nc, 3, nz + 1),
    the latter a ``torch.cat`` of slices of a moved-axis view."""
    uv = torch.zeros((8, 3, NZ3, 2, 2), dtype=torch.float32)
    f = uv.movedim(-1, 0)
    prof = torch.cat([f[..., :, 0], f[..., -1:, 1]], dim=-1)
    a = torch.zeros((8, 3, NZ3 + 1), dtype=torch.float32)
    assert form((-a, 1.0 + a, -a, prof)) == 2
    # the tracer solve: all four of one shape
    assert form((-a, 1.0 + a, -a, prof[0])) == 1


@pytest.mark.parametrize("case", ["rhs_lead_on_coeff", "coeff_lead", "mixed",
                                  "stride0_coeff", "stride0_lead",
                                  "broadcast_rhs", "stride0_rhs",
                                  "coeff_shapes_differ", "transposed_coeff",
                                  "leading_one"])
def test_shared_form_refused_in_doubt(case):
    """Every other broadcast pattern, and any operand that is not dense in
    memory, is copied first (None)."""
    z = lambda *sh: torch.zeros(sh, dtype=torch.float64)  # noqa: E731
    ops = {
        # a coefficient carries the leading axis, the rhs does not
        "rhs_lead_on_coeff": (z(2, 4, 13), z(4, 13), z(4, 13), z(4, 13)),
        "coeff_lead": (z(2, 6, 3, 13), z(6, 3, 13), z(6, 3, 13),
                       z(6, 3, 13)),
        "mixed": (z(1, 6, 3, 13), z(2, 1, 3, 13), z(6, 1, 13),
                  z(2, 6, 3, 13)),
        # coefficients expanded by the caller: stride 0 on an axis
        "stride0_coeff": (z(1, 13).expand(6, 13), z(6, 13), z(6, 13),
                          z(2, 6, 13)),
        "stride0_lead": tuple(z(6, 13).expand(2, 6, 13) for _ in range(3))
        + (z(2, 6, 13),),
        "broadcast_rhs": (z(6, 13), z(6, 13), z(6, 13), z(1, 13)),
        "stride0_rhs": (z(6, 13), z(6, 13), z(6, 13),
                        z(6, 13).expand(2, 6, 13)),
        "coeff_shapes_differ": (z(6, 13), z(1, 13), z(6, 13), z(2, 6, 13)),
        "transposed_coeff": (z(13, 6).T, z(6, 13), z(6, 13), z(2, 6, 13)),
        "leading_one": (z(1, 6, 13), z(1, 6, 13), z(1, 6, 13),
                        z(2, 6, 13)),
    }[case]
    assert form(ops) is None


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nrhs", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 13, 14, 32, 300])
def test_tile_geometry_within_the_cards_limits(n, nrhs, itemsize):
    """Shared bytes within a block's 227 KB, an odd stride that holds a
    column, a grid that covers the batch, 16-byte aligned tiles, and at the
    bench's two batches a block for each of the 132 SMs."""
    for bc in (1, 63, 64, 65, 3 * NC3, 6 * NC3, 1000003):
        g = tridiag.tile_geometry(bc, n, itemsize, nrhs)
        assert g is not None
        assert g.stride % 2 == 1 and n <= g.stride <= n + 1
        assert g.group in (1, 2) and nrhs % g.group == 0
        assert g.smem_bytes == (3 + g.group) * g.cols * g.stride * itemsize
        assert g.smem_bytes <= tridiag._SMEM_MAX == 227 * 1024
        assert (g.cols * g.stride * itemsize) % 16 == 0
        assert g.cols in tridiag._TILE_COLS and g.cols % 4 == 0
        assert g.cols <= g.threads <= 1024 and g.threads % 32 == 0
        assert (g.grid - 1) * g.cols < bc <= g.grid * g.cols
        if bc in (3 * NC3, 6 * NC3) and n == NZ3 + 1:
            assert g.grid >= 132 and g.cols == 64
            assert g.smem_bytes <= 48 * 1024  # no attribute needed


@pytest.mark.parametrize("itemsize,nrhs,n_general",
                         [(4, 1, 1816), (4, 2, 1452), (8, 1, 908),
                          (8, 2, 726)])
def test_general_kernel_takes_over_where_no_tile_fits(itemsize, nrhs,
                                                      n_general):
    """The n from which the source's header says the general kernel runs."""
    assert tridiag.tile_geometry(100, n_general - 1, itemsize, nrhs).cols == 8
    for n in (n_general, n_general + 1, 10 * n_general):
        assert tridiag.tile_geometry(100, n, itemsize, nrhs) is None


@pytest.mark.parametrize("nrhs", [1, 2, 3])
def test_shared_coefficients_match_reference_and_dense(nrhs):
    """Coefficients (bc, n) against (R, bc, n) right-hand sides: the plain
    version takes them by broadcasting, as the reference does."""
    ops = system([(6, 3)] * 3 + [(nrhs, 6, 3)], 13, seed=20 + nrhs)
    assert form(tuple(torch.tensor(o) for o in ops)) == nrhs
    got, want = solve_both(ops)
    assert got.shape == want.shape == (nrhs, 6, 3, 13)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert dense_residual(ops, got) < 1e-10
    # each right-hand side alone gives the same bits
    alone = np.stack([tridiag.tridiag_solve(
        *(torch.tensor(o) for o in ops[:3]), torch.tensor(r)).numpy()
        for r in ops[3]])
    assert np.array_equal(alone, got)


@pytest.mark.parametrize("bc,n,nrhs", RAGGED_TRIDIAG)
def test_ragged_cases_match_reference(bc, n, nrhs):
    """The list that ``chip_smoke.py`` runs on the card: column counts
    around the 64-column tile and the bench's batches, n from 1 to 300,
    one and two right-hand sides a column.  Each is read as given, fits a
    tile in f32, and its plain version matches the reference."""
    ops = ragged_tridiag_case(bc, n, nrhs, seed=bc + n)
    assert ops[3].shape == ((bc, n) if nrhs == 1 else (nrhs, bc, n))
    assert form(tuple(torch.from_numpy(o) for o in ops)) == nrhs
    assert bc % 64 != 0
    g32 = tridiag.tile_geometry(bc, n, 4, nrhs)
    assert g32 is not None and (g32.cols == 64) == (n < 300)
    got, want = solve_both(ops)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
