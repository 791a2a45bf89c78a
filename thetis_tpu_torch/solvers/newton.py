"""Krylov core and solver parameters (port of the parts of
``thetis_tpu/solvers/newton.py`` that the assembled semi-implicit path
runs: :class:`NewtonParameters` and the restarted FGMRES core).

The reference runs FGMRES inside ``lax.while_loop``/``fori_loop``; here
the loops are eager Python.  The Arnoldi loop keeps exactly ``restart``
iterations with a breakdown guard, so both packages walk the same Krylov
path wherever the reference's guard does not fire spuriously (see
``_fgmres_flat``), and each restart cycle costs one host sync (the
small least-squares problem and the convergence test run on the host).
The matrix-free Newton solve and its adjoint are not ported yet.
"""
import math

import torch

__all__ = ["NewtonParameters"]


class NewtonParameters:
    """Krylov tolerances (cf. reference ``options.py`` solver_parameters
    dicts).  Only the KSP fields are ported: the one solve the port runs
    is linear (semi-implicit), so the reference's SNES fields have no
    reader yet."""

    def __init__(self, ksp_rtol=1e-7, ksp_max_it=48, gmres_restart=16):
        self.ksp_rtol = ksp_rtol
        self.ksp_max_it = ksp_max_it
        self.gmres_restart = gmres_restart


def _fgmres_flat(mv, b, M, rtol, restart, max_cycles):
    """Restarted *flexible* GMRES (FGMRES, right-preconditioned) on flat
    vectors: classic Arnoldi + small dense least-squares per cycle
    (Saad 1993; PETSc ``-ksp_type fgmres``).

    :arg mv: operator, flat tensor -> flat tensor
    :arg b: right-hand side (n,)
    :arg M: preconditioner, flat -> flat (stored per iteration: Z_j)
    :arg rtol: relative tolerance on the true residual, as a float
    :returns: ``(x, rnorm, bnorm)`` with the projected residual norm
        ``rnorm`` and ``bnorm = ||b||`` as Python floats

    The small (m+1, m) least squares runs on the host in float64 through
    the pseudo-inverse (SVD): a rank-deficient H from Arnoldi breakdown
    yields the minimum-norm y, as the reference's SVD ``lstsq`` does.
    (``torch.linalg.lstsq`` on CUDA offers only ``gels``, which assumes
    full rank.)"""
    n = b.shape[0]
    m = int(restart)
    fi = torch.finfo(b.dtype)
    tiny, brk = fi.tiny, fi.eps

    bnorm = float(torch.linalg.vector_norm(b))
    x = torch.zeros_like(b)
    it = 0
    rnorm = math.inf
    while it < max_cycles and rnorm > rtol * bnorm:
        r = b - mv(x)
        beta = torch.linalg.vector_norm(r)
        beta_floor = torch.clamp_min(beta, tiny)
        V = b.new_zeros((m + 1, n))
        V[0] = r / beta_floor
        Z = b.new_zeros((m, n))
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            z = M(V[j])
            w = mv(z)
            wnorm = torch.linalg.vector_norm(w)
            # Gram-Schmidt against all rows: rows > j are still zero
            h = V @ w                                     # (m+1,)
            w = w - h @ V
            hj1 = torch.linalg.vector_norm(w)
            # breakdown (Krylov space exhausted: w lay in the basis up to
            # roundoff): keep a zero basis row instead of dividing by ~0;
            # the least squares ignores it.  The test is relative to |A z|
            # (scale-free); the reference's eps * beta mixes residual and
            # operator units and fires spuriously in f32 when beta is large
            v_next = torch.where(hj1 > brk * wnorm,
                                 w / torch.clamp_min(hj1, tiny),
                                 torch.zeros_like(w))
            H[:, j] = h
            H[j + 1, j] = hj1
            V[j + 1] = v_next
            Z[j] = z
        host = torch.cat([H.reshape(-1), beta.reshape(1)]).to(
            "cpu", torch.float64)
        Hh = host[:-1].reshape(m + 1, m)
        e1 = torch.zeros(m + 1, dtype=torch.float64)
        e1[0] = host[-1]
        y = torch.linalg.pinv(Hh) @ e1
        x = x + y.to(b.dtype).to(b.device) @ Z
        # projected residual estimate ||beta e1 - H y|| == ||b - A x|| in
        # exact arithmetic; the next cycle restarts from the true residual
        rnorm = float(torch.linalg.vector_norm(e1 - Hh @ y))
        it += 1
    return x, rnorm, bnorm
