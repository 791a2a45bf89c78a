"""Matrix-free Newton-Krylov solver and the FGMRES core (port of
``thetis_tpu/solvers/newton.py``).

Jacobian-vector products come from a linearization built once per
Newton iteration, as the reference's ``jax.linearize``: reverse mode
over reverse mode (the graph of ``J^T w`` for a dummy ``w``; each matvec
is one backward pass of it, ``J v = d(J^T w)/dw . v``).  A forward-mode
``torch.func.jvp`` per matvec gives the same products but costs ~4x
more host time: under forward AD every product of a dual tensor with a
plain one goes through a Python reference decomposition (~0.4 ms a
product on the CPU build of torch 2.13).  The dense path
(``NewtonParameters(dense=True)``) builds the Jacobian with
``torch.func.vmap`` of ``torch.func.jvp``.  Linear solves come from the
restarted FGMRES below.
The reference's ``lax.while_loop``s are host loops here: each Newton
iteration and each restart cycle costs one host sync (the residual norm
and the small least-squares problem are read on the host).  The Arnoldi
loop keeps exactly ``restart`` iterations with a breakdown guard, so
both packages walk the same Krylov path wherever the reference's guard
does not fire spuriously (see :func:`_fgmres_flat`).

:func:`newton_solve` is differentiable by the implicit function theorem,
as the reference's ``_newton_cv`` ``custom_vjp``
(``thetis_tpu/solvers/newton.py:263-288``): the iteration runs with its
linear solves under ``no_grad``, the residual at the root ``r = F(u*)``
keeps its graph to the tensors the residual closes over, and the result
is ``u* + S(r)`` with :class:`_NewtonAdjoint` ``S``: zeros forward, and
backward ``-lam`` with ``J^T lam = gbar`` solved by the same FGMRES and
preconditioner (``J^T w`` one VJP of the residual at ``u*``), or by the
transposed dense Jacobian under ``dense=True``.  So the parameters get
``-(dF/dparams)^T lam`` and the initial guess nothing, and autograd never
tapes a Krylov iteration.
"""
import math

import torch

__all__ = ["newton_solve", "NewtonParameters", "linear_solve"]


class NewtonParameters:
    """SNES/KSP tolerances (cf. reference ``options.py`` solver_parameters
    dicts), with the reference's fields and defaults."""

    def __init__(self, snes_rtol=1e-8, snes_atol=1e-10, snes_max_it=8,
                 ksp_rtol=1e-7, ksp_max_it=48, gmres_restart=16,
                 line_search=False, dense=False, monitor_convergence=False):
        self.snes_rtol = snes_rtol
        self.snes_atol = snes_atol
        self.snes_max_it = snes_max_it
        self.ksp_rtol = ksp_rtol
        self.ksp_max_it = ksp_max_it
        self.gmres_restart = gmres_restart
        self.line_search = line_search
        #: materialize the Jacobian and LU-solve (PETSc 'preonly'+'lu'
        #: analogue; for small/steady problems where Krylov stalls)
        self.dense = dense
        #: PETSc error_on_nonconvergence analogue: report the final Krylov
        #: residual after every solve (the NaN divergence guard is always
        #: on)
        self.monitor_convergence = monitor_convergence


# -- dict-of-tensor helpers (the reference's pytrees) ---------------------
def _ravel(tree):
    """Flatten a dict of tensors in sorted key order (the order of
    ``jax.flatten_util.ravel_pytree``): ``(flat, unravel)``."""
    keys = sorted(tree)
    shapes = [tree[k].shape for k in keys]
    sizes = [tree[k].numel() for k in keys]
    flat = torch.cat([tree[k].reshape(-1) for k in keys])

    def unravel(v):
        out, off = {}, 0
        for k, s, n in zip(keys, shapes, sizes):
            out[k] = v[off:off + n].reshape(s)
            off += n
        return out

    return flat, unravel


def _norm(tree):
    return torch.sqrt(sum((v * v).sum() for v in tree.values()))


def _axpy(a, x, y):
    return {k: a * x[k] + y[k] for k in y}


def _neg(tree):
    return {k: -v for k, v in tree.items()}


def _lstsq_pinv(H, beta):
    """Minimum-norm solution of ``min ||beta e1 - H y||`` for the small
    (m+1, m) Hessenberg matrix, in float64 through the pseudo-inverse
    (SVD): a rank-deficient H from Arnoldi breakdown yields the
    minimum-norm y, as the reference's SVD ``lstsq`` does
    (``torch.linalg.lstsq`` on CUDA offers only ``gels``, which assumes
    full rank).  Runs on H's device; returns float64 ``(y, e1)``."""
    Hd = H.to(torch.float64)
    e1 = torch.zeros(H.shape[0], dtype=torch.float64, device=H.device)
    e1[0] = beta
    return torch.linalg.pinv(Hd) @ e1, e1


#: the Krylov vectors' reductions and combinations ``(dots, norm, comb)``
#: on one flat vector (:func:`_partitioned` for a split one)
_SERIAL = (lambda V, w: V @ w, torch.linalg.vector_norm,
           lambda c, V: c @ V)


def _partitioned(allreduce):
    """``(dots, norm, comb)`` on ``(D, n_d)`` vectors split over D
    partitions: every dot product and norm sums the partitions' partials
    through ``allreduce`` (in partition order)."""
    def dots(V, w):
        return allreduce(torch.einsum("mdn,dn->dm", V, w))

    def norm(v):
        return torch.sqrt(allreduce((v * v).sum(-1)))

    return dots, norm, lambda c, V: torch.tensordot(c, V, 1)


def _arnoldi_step(V, j, w, brk, tiny, red=_SERIAL):
    """Gram-Schmidt of ``w = A M v_j`` against all rows of ``V`` (rows
    > j are still zero) and the next basis vector.  Returns ``(h,
    hj1)`` and writes ``V[j + 1]``.

    Breakdown (Krylov space exhausted: w lay in the basis up to
    roundoff) keeps a zero basis row instead of dividing by ~0; the least
    squares ignores it.  The test is relative to ``||A M v_j||``
    (scale-free).  The reference tests ``hj1 > eps * beta`` (beta the
    right-hand side's norm), which mixes residual and operator units: in
    f32, when beta is large, it fires on every step and the solve
    collapses to one Arnoldi step (ROADMAP C).  Both norms of the guard
    go through ``red``, so on a split vector every partition takes the
    same branch."""
    dots, norm, comb = red
    wnorm = norm(w)
    h = dots(V, w)                                # (m+1,)
    w = w - comb(h, V)
    hj1 = norm(w)
    V[j + 1] = torch.where(hj1 > brk * wnorm,
                           w / torch.clamp_min(hj1, tiny),
                           torch.zeros_like(w))
    return h, hj1


def fixed_gmres(A, M, b, m):
    """``m`` Arnoldi iterations of non-restarted, right-preconditioned
    GMRES on ``A x = b`` from ``x = 0`` (flat vectors), with no
    convergence test: the inner solve of the assembled preconditioners
    (``AssembledWavePC._solve``, ``SchurFieldsplitPC._ssolve``).  The
    small least squares stays on the device (f64 pseudo-inverse), so an
    application needs no host sync."""
    n = b.shape[0]
    fi = torch.finfo(b.dtype)
    tiny, brk = fi.tiny, fi.eps
    beta = torch.linalg.vector_norm(b)
    V = b.new_zeros((m + 1, n))
    V[0] = b / torch.clamp_min(beta, tiny)
    Z = b.new_zeros((m, n))
    H = b.new_zeros((m + 1, m))
    for j in range(m):
        z = M(V[j])
        h, hj1 = _arnoldi_step(V, j, A(z), brk, tiny)
        H[:, j] = h
        H[j + 1, j] = hj1
        Z[j] = z
    y, _ = _lstsq_pinv(H, beta)
    return y.to(b.dtype) @ Z


def _fgmres_flat(mv, b, M, rtol, restart, max_cycles, stats=None,
                 allreduce=None):
    """Restarted *flexible* GMRES (FGMRES, right-preconditioned) on flat
    vectors: classic Arnoldi + small dense least-squares per cycle
    (Saad 1993; PETSc ``-ksp_type fgmres``).

    :arg mv: operator, flat tensor -> flat tensor
    :arg b: right-hand side (n,)
    :arg M: preconditioner, flat -> flat (stored per iteration: Z_j)
    :arg rtol: relative tolerance on the true residual, as a float
    :arg stats: optional dict; ``ksp_cycles`` is increased by the
        number of restart cycles run
    :arg allreduce: optional; sums a tensor of per-partition partial
        reductions over its leading axis, in partition order
        (:func:`~thetis_tpu_torch.parallel.shard.allreduce`, the
        reference's ``lax.psum`` hook).  The vectors are then ``(D, n_d)``
        tensors, row d partition d's entries, and every dot product and
        norm, the breakdown guard's two included, is the sum of the
        partitions' partials: the PETSc VecDot-allreduce pattern
        (``parallel/assembled_sharded.py``).
    :returns: ``(x, rnorm, bnorm)`` with the projected residual norm
        ``rnorm`` and ``bnorm = ||b||`` as Python floats

    The small (m+1, m) least squares runs on the host in float64 (see
    :func:`_lstsq_pinv`); its result decides the loop, so each cycle
    costs one host sync."""
    m = int(restart)
    fi = torch.finfo(b.dtype)
    tiny, brk = fi.tiny, fi.eps
    red = _SERIAL if allreduce is None else _partitioned(allreduce)
    _, norm, comb = red

    bnorm = float(norm(b))
    x = torch.zeros_like(b)
    it = 0
    rnorm = math.inf
    while it < max_cycles and rnorm > rtol * bnorm:
        r = b - mv(x)
        beta = norm(r)
        V = b.new_zeros((m + 1,) + b.shape)
        V[0] = r / torch.clamp_min(beta, tiny)
        Z = b.new_zeros((m,) + b.shape)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            z = M(V[j])
            h, hj1 = _arnoldi_step(V, j, mv(z), brk, tiny, red)
            H[:, j] = h
            H[j + 1, j] = hj1
            Z[j] = z
        host = torch.cat([H.reshape(-1), beta.reshape(1)]).to(
            "cpu", torch.float64)
        Hh = host[:-1].reshape(m + 1, m)
        y, e1 = _lstsq_pinv(Hh, host[-1])
        x = x + comb(y.to(b.dtype).to(b.device), Z)
        # projected residual estimate ||beta e1 - H y|| == ||b - A x|| in
        # exact arithmetic; the next cycle restarts from the true residual
        rnorm = float(torch.linalg.vector_norm(e1 - Hh @ y))
        it += 1
    if stats is not None:
        stats["ksp_cycles"] = stats.get("ksp_cycles", 0) + it
    return x, rnorm, bnorm


def _linsolve(matvec, b, precond, params, stats=None):
    """Right-preconditioned FGMRES solve of ``matvec(x) = b`` on dicts of
    tensors (or the dense LU solve with ``params.dense``).  ``stats``,
    when given, collects ``ksp_cycles`` (summed) and the last solve's
    ``ksp_rel_residual``."""
    b_flat, unravel = _ravel(b)

    def mv(v):
        return _ravel(matvec(unravel(v)))[0]

    if getattr(params, "dense", False):
        n = b_flat.shape[0]
        eye = torch.eye(n, dtype=b_flat.dtype, device=b_flat.device)
        fwd = getattr(matvec, "dense_jvp", matvec)
        A = torch.func.vmap(lambda v: _ravel(fwd(unravel(v)))[0],
                            in_dims=1, out_dims=1)(eye)
        return unravel(torch.linalg.solve(A, b_flat))

    if precond is not None:
        def M(v):
            return _ravel(precond(unravel(v)))[0]
    else:
        def M(v):
            return v

    x_flat, rnorm, bnorm = _fgmres_flat(
        mv, b_flat, M, params.ksp_rtol, params.gmres_restart,
        max(1, params.ksp_max_it // params.gmres_restart), stats)
    bsafe = max(bnorm, torch.finfo(b_flat.dtype).tiny)
    if stats is not None:
        stats["ksp_rel_residual"] = rnorm / bsafe
    # Krylov divergence guard (PETSc raises on KSP_DIVERGED_DTOL when the
    # residual grows by divtol=1e4; as the reference, poison the solution
    # with NaN instead).  Stagnation at roundoff is NOT divergence.
    diverged = rnorm > 1e4 * bsafe
    if getattr(params, "monitor_convergence", False):
        from ..utils.log import print_output

        print_output(f"KSP final rel. residual {rnorm / bsafe} "
                     f"(diverged={diverged})")
    if diverged:
        x_flat = torch.full_like(x_flat, float("nan"))
    return unravel(x_flat)


def _tangent_map(f, x):
    """The Jacobian of ``f`` at ``x`` as a linear map (keys in ``x``'s
    order), linearized once: the graph of ``g(w) = J^T w`` is built here
    and each application is one backward pass of it, ``J v = d(w . J v)/dw
    = grad(g, w, v)``.  ``jvp_fn.dense_jvp`` is the forward-mode product
    of the same map, for ``torch.func.vmap``."""
    keys = list(x)
    with torch.enable_grad():
        xs = {k: x[k].detach().requires_grad_(True) for k in keys}
        out = f(xs)
        out_keys = list(out)
        ws = [torch.zeros_like(out[k], requires_grad=True) for k in out_keys]
        g = torch.autograd.grad([out[k] for k in out_keys],
                                [xs[k] for k in keys], ws,
                                create_graph=True, allow_unused=True)
    # inputs the residual does not read, or reads only linearly with a
    # constant Jacobian block, leave no graph to differentiate
    live = [i for i, gi in enumerate(g)
            if gi is not None and gi.requires_grad]

    def jvp_fn(v):
        if not live:
            return {k: torch.zeros_like(out[k]) for k in out_keys}
        jv = torch.autograd.grad([g[i] for i in live], ws,
                                 [v[keys[i]] for i in live],
                                 retain_graph=True, allow_unused=True)
        return {k: (t.detach() if t is not None
                    else torch.zeros_like(out[k]))
                for k, t in zip(out_keys, jv)}

    def dense_jvp(v):
        v = {k: v[k] for k in x}  # tangents in the primal's key order
        return torch.func.jvp(f, (x,), (v,))[1]

    jvp_fn.dense_jvp = dense_jvp
    return jvp_fn


def _on_graph(tree):
    return any(v.requires_grad for v in tree.values())


def _newton_iterate(f, u0, precond, params, stats):
    """Newton iterations from ``u0`` (no gradient): ``(u, r)``, with ``r
    = f(u)`` evaluated under the caller's grad mode when the residual
    reads a tensor that requires grad (else None).  Only the residual
    evaluations see grad mode; the iterates and linear solves never carry
    a graph."""
    if params.snes_max_it == 1:
        # semi-implicit / Picard 'ksponly' path: single linear solve
        # (ref timeintegrator.py:186-211)
        f0 = f(u0)
        with torch.no_grad():
            du = _linsolve(_tangent_map(f, u0), _neg(f0), precond, params,
                           stats)
            x = _axpy(1.0, du, u0)
        stats["newton_iterations"] = 1
        return x, (f(x) if _on_graph(f0) else None)

    x = u0
    fx = f(u0)
    r0 = float(_norm(fx).detach())
    tol = max(params.snes_rtol * r0, params.snes_atol)
    rnorm = r0
    i = 0
    while i < params.snes_max_it and rnorm > tol:
        with torch.no_grad():
            du = _linsolve(_tangent_map(f, x), _neg(fx), precond, params,
                           stats)
            x_new = _axpy(1.0, du, x)
        fx_new = f(x_new)
        rn_new = float(_norm(fx_new).detach())
        if params.line_search:
            # backtracking: halve the step while the residual norm does
            # not decrease (PETSc 'newtonls' analogue)
            alpha = 1.0
            while alpha > 1.0 / 64.0 and rn_new >= rnorm:
                alpha = 0.5 * alpha
                with torch.no_grad():
                    x_new = _axpy(alpha, du, x)
                fx_new = f(x_new)
                rn_new = float(_norm(fx_new).detach())
        x, fx, rnorm = x_new, fx_new, rn_new
        i += 1
    stats["newton_iterations"] = i
    stats["snes_rel_residual"] = rnorm / max(r0, torch.finfo(
        fx[sorted(fx)[0]].dtype).tiny)
    return x, (fx if _on_graph(fx) else None)


def _dense_jacobian(f, u):
    """The Jacobian of ``f`` at ``u`` as a dense matrix on ``_ravel``'s
    flat vectors (forward mode under ``vmap``, as ``dense_jvp``)."""
    u_flat, unravel = _ravel(u)
    eye = torch.eye(u_flat.shape[0], dtype=u_flat.dtype, device=u_flat.device)

    def col(v):
        v = unravel(v)
        return _ravel(torch.func.jvp(f, (u,), ({k: v[k] for k in u},))[1])[0]

    return torch.func.vmap(col, in_dims=1, out_dims=1)(eye)


def _adjoint_solve(f, u, g, precond, params, stats):
    """``lam`` with ``J^T lam = g``, ``J`` the Jacobian of ``f`` at ``u``
    (the reference's ``_newton_cv_bwd``): FGMRES on VJPs of one graph of
    ``f`` at ``u``, preconditioned by the forward's preconditioner (its
    ``transpose()`` where it has one); the transposed dense Jacobian under
    ``dense=True``."""
    if getattr(params, "dense", False):
        g_flat, unravel = _ravel(g)
        J = _dense_jacobian(f, {k: u[k].detach() for k in u})
        return unravel(torch.linalg.solve(J.T, g_flat))
    keys = list(u)
    with torch.enable_grad():
        xs = {k: u[k].detach().requires_grad_(True) for k in keys}
        out = f(xs)
    out_keys = list(out)

    def JT(w):
        gr = torch.autograd.grad([out[k] for k in out_keys],
                                 [xs[k] for k in keys],
                                 [w[k] for k in out_keys],
                                 retain_graph=True, allow_unused=True)
        return {k: (t if t is not None else torch.zeros_like(xs[k]))
                for k, t in zip(keys, gr)}

    # the forward's preconditioner, transposed where it is not symmetric
    # (the reference reuses it as it is, right for the mass inverse)
    transpose = getattr(precond, "transpose", None)
    astats = {}
    lam = _linsolve(JT, g, transpose() if transpose else precond, params,
                    astats)
    stats["adjoint_ksp_cycles"] = (stats.get("adjoint_ksp_cycles", 0)
                                   + astats.get("ksp_cycles", 0))
    stats["adjoint_ksp_rel_residual"] = astats.get("ksp_rel_residual")
    return lam


class _NewtonAdjoint(torch.autograd.Function):
    """``S(r)`` of :func:`newton_solve`: ``apply(f, u, precond, params,
    stats, *r)`` with ``r`` the residual's values at the root ``u``
    (sorted keys) returns zeros, so ``u + S(r)`` is the root; its backward
    maps the root's cotangent ``gbar`` to ``r_bar = -lam``, ``J^T lam =
    gbar``, and autograd carries that through ``r``'s graph to the
    parameters: ``-(dF/dparams)^T lam``."""

    @staticmethod
    def forward(f, u, precond, params, stats, *r):
        return tuple(torch.zeros_like(v) for v in r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.solve = inputs[:5]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gbar):
        f, u, precond, params, stats = ctx.solve
        keys = sorted(u)
        lam = _adjoint_solve(f, u, dict(zip(keys, gbar)), precond, params,
                             stats)
        return (None,) * 5 + tuple(-lam[k] for k in keys)


def newton_solve(residual_fn, u0, precond=None, params=None, stats=None):
    """Solve ``residual_fn(u) = 0`` by Newton-GMRES.

    :arg residual_fn: dict of tensors -> dict of tensors (same keys)
    :arg precond: linear operator approximating J^-1 (e.g. inverse mass)
    :arg stats: optional dict, filled with ``newton_iterations``,
        ``ksp_cycles`` (summed over the Newton iterations),
        ``ksp_rel_residual`` (the last linear solve's projected relative
        residual) and, for a Newton loop, ``snes_rel_residual``
    :returns: the solution dict, differentiable with respect to the
        tensors ``residual_fn`` closes over by the implicit function
        theorem (none flows to ``u0``, the initial guess); ``stats`` gains
        ``adjoint_ksp_cycles`` when a backward pass runs the adjoint solve
    """
    params = params or NewtonParameters()
    stats = {} if stats is None else stats
    u, r = _newton_iterate(residual_fn, {k: v.detach() for k, v in u0.items()},
                           precond, params, stats)
    if r is None:
        return u
    keys = sorted(r)
    zeros = _NewtonAdjoint.apply(residual_fn, u, precond, params, stats,
                                 *[r[k] for k in keys])
    zeros = dict(zip(keys, zeros))
    return {k: u[k] + zeros[k] for k in u}


def linear_solve(matvec, b, precond=None, rtol=1e-7, restart=16, maxiter=3):
    """Preconditioned GMRES convenience wrapper (PETSc KSP analogue)."""
    p = NewtonParameters(ksp_rtol=rtol, ksp_max_it=restart * maxiter,
                         gmres_restart=restart)
    return _linsolve(matvec, b, precond, p)
