"""Fixed-iteration Jacobi-preconditioned conjugate gradients.

The mass inverses of the CG and H(div) spaces (the CG1 tracer mass, the
CG2 elevation mass of ``dg-cg``, the RT/BDM velocity masses) are all the
same loop in the reference, a ``lax.scan`` of a fixed length wrapped in
``lax.custom_linear_solve(..., symmetric=True)``
(``thetis_tpu/fem/rt.py:247-273`` and its copies): a solve of a
symmetric operator that does not depend on the controls, so its
transpose, its tangent and its batched form are the same solve applied
to the cotangent, the tangent and each batch member.  :class:`JacobiPCG`
is that solve as a ``torch.autograd.Function``: gradients, ``torch.func``
JVPs (the Newton Jacobian products ``_tangent_map`` and ``dense_jvp``
make through the residuals that hold these solves) and ``vmap`` (colour
probing) all go through it, never through the loop's iterations.  A
fixed count keeps the loop free of host syncs and gives both packages the
same iterates.

The loop is ~15 small launches an iteration, so 30-50 iterations cost
the host far more than the device; :class:`JacobiPCG` captures it once
per input shape as a CUDA graph on the card and replays it: the same
kernels in the same order, launched at once.
"""
import gc

import torch

__all__ = ["jacobi_pcg", "JacobiPCG"]


def jacobi_pcg(apply, b, diag, iterations):
    """``iterations`` CG steps on ``apply(x) = b`` (SPD), preconditioned
    by ``diag`` and started from ``b / diag``; the reference's guards
    (``finfo(dtype).tiny`` under both denominators) are kept.  The loop
    runs on flat vectors; the updates are fused multiply-adds and the
    inner products ``dot``s: ten launches an iteration besides
    ``apply``."""
    tiny = torch.finfo(b.dtype).tiny
    shape = b.shape
    if b.dim() != 1:
        apply_shaped = apply

        def apply(v):
            return apply_shaped(v.view(shape)).reshape(-1)

        b, diag = b.reshape(-1), diag.reshape(-1)
    x = b / diag
    res = b - apply(x)
    p = res / diag
    rz = torch.dot(res, p)
    for _ in range(iterations):
        Ap = apply(p)
        alpha = rz / torch.clamp_min(torch.dot(p, Ap), tiny)
        x = torch.addcmul(x, alpha, p)
        res = torch.addcmul(res, alpha, Ap, value=-1.0)
        z = res / diag
        rz_new = torch.dot(res, z)
        p = torch.addcmul(z, rz_new / torch.clamp_min(rz, tiny), p)
        rz = rz_new
    return x.view(shape)


class _MassSolve(torch.autograd.Function):
    """``x = apply^{-1} b`` by a :class:`JacobiPCG` ``pcg``: the solve is
    symmetric and constant, so the backward, the JVP and each member of a
    batch are the same solve (and the backward's own backward too).  The
    forward may capture a CUDA graph only where ``capture`` is set: the
    top-level call, never the backward (autograd runs it on another
    thread), the JVP or a batch member."""

    @staticmethod
    def forward(b, pcg, capture):
        return pcg._run(b, capture)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.pcg = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _MassSolve.apply(g, ctx.pcg, False), None, None

    @staticmethod
    def jvp(ctx, b_dot, *_):
        return _MassSolve.apply(b_dot, ctx.pcg, False)

    @staticmethod
    def vmap(info, in_dims, b, pcg, capture):
        if in_dims[0] is None:
            return _MassSolve.apply(b, pcg, False), None
        return torch.stack([_MassSolve.apply(bi, pcg, False)
                            for bi in b.unbind(in_dims[0])]), 0


class JacobiPCG:
    """:func:`jacobi_pcg` of a fixed symmetric operator, preconditioner
    and count, differentiable as a linear solve (:class:`_MassSolve`).

    On a CUDA tensor the loop is captured as a CUDA graph the first time
    a shape and dtype come to a top-level call, and replayed from then on,
    in the forward and in the backward (the input copied into the graph's
    buffer, the result cloned out of it); ``apply`` must read only tensors
    that stay in place, as a mass matrix's tables do.  A capture that
    fails raises.  On the CPU the loop runs eagerly; so does a solve on
    the card whose shape no top-level call has captured yet.  ``replays``
    counts the graph replays and ``eager_cuda`` the eager solves of CUDA
    tensors."""

    def __init__(self, apply, diag, iterations):
        self.apply = apply
        self.diag = diag
        self.iterations = int(iterations)
        self._graphs = {}
        self.replays = 0
        self.eager_cuda = 0

    def _solve(self, b):
        return jacobi_pcg(self.apply, b, self.diag, self.iterations)

    def __call__(self, b):
        return _MassSolve.apply(b, self, True)

    def _run(self, b, capture):
        if not b.is_cuda:
            return self._solve(b)
        key = (tuple(b.shape), b.dtype)
        if key not in self._graphs:
            if not capture:
                self.eager_cuda += 1
                return self._solve(b)
            self._graphs[key] = self._capture(b)
        b_in, x_out, graph = self._graphs[key]
        b_in.copy_(b)
        graph.replay()
        self.replays += 1
        return x_out.clone()

    def _capture(self, b):
        b_in = b.detach().clone()
        # one eager run on a side stream first: lazy initialisations
        # (cuBLAS handles, workspaces) must not happen inside the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad(), torch.cuda.stream(side):
            self._solve(b_in)
        torch.cuda.current_stream().wait_stream(side)
        # no collection during the capture: a collected object that owns
        # a graph or a stream-recorded block would make a CUDA call the
        # capture forbids, which invalidates it
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                x_out = self._solve(b_in)
        finally:
            if collecting:
                gc.enable()
        return b_in, x_out, graph
