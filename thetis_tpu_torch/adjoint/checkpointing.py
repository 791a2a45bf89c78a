r"""Adjoint memory checkpointing for long time loops (port of
``thetis_tpu/adjoint/checkpointing.py``).

The reference bounds adjoint memory by pyadjoint tape checkpointing; the
JAX package rematerialises chunks of its ``lax.scan`` under
``jax.checkpoint``.  Here :func:`checkpointed_scan` runs the time loop as
chunks, each under ``torch.utils.checkpoint.checkpoint(use_reentrant=
False)``: the backward keeps only the chunk-boundary carries (``n /
chunk`` of them) and one chunk's activations while it replays that chunk,
the :math:`O(\sqrt{N})` schedule at ``chunk ~ sqrt(N)``, for one extra
forward of each chunk.  The replay must repeat the forward's graph: the
solvers run their iterations under ``no_grad`` and build the same graph
whatever their iteration counts.
"""
import math

from torch.utils.checkpoint import checkpoint

__all__ = ["checkpointed_scan"]


def _steps(body, carry, m):
    for _ in range(m):
        carry = body(carry)
    return carry


def checkpointed_scan(body, carry, n, chunk=None):
    """Run ``carry = body(carry)`` ``n`` times with sqrt-N
    rematerialisation.

    :arg body: ``carry -> carry`` (one time step)
    :arg carry: initial carry (any nest of tensors and Python values)
    :arg n: number of steps
    :kwarg chunk: steps per rematerialised chunk (default
        ``ceil(sqrt(n))``)
    :returns: final carry
    """
    n = int(n)
    if n <= 0:
        return carry
    if chunk is None:
        chunk = max(1, int(math.ceil(math.sqrt(float(n)))))
    chunk = max(1, min(int(chunk), n))
    n_outer, rem = divmod(n, chunk)
    for m in [chunk] * n_outer + ([rem] if rem else []):
        carry = checkpoint(_steps, body, carry, m, use_reentrant=False)
    return carry
