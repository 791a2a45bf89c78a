"""Tridiagonal column solve port: ``tridiag_solve`` of
``thetis_tpu_torch/kernels/tridiag.py`` (on CPU tensors its plain version,
the Python-loop Thomas recurrence beside the CUDA kernel
``csrc/tridiag.cu``) against the reference's ``tridiag_solve`` (on the
CPU its ``_thomas_scan``) and against dense numpy solves.  f64; rtol
1e-12 against the reference (the same recurrence, operation for
operation) and 1e-10 on the dense residual (the reference's own bound in
``tests/test_kernels.py``); the f32 plain version against f64 at 1e-5
(f32 roundoff on a well-conditioned system).

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``tridiag_reference`` there); here the wrapper must take the
plain version for CPU tensors without counting a launch."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.kernels import tridiag_solve as j_solve  # noqa: E402
from thetis_tpu_torch.kernels import tridiag  # noqa: E402


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
