r"""Tracing / profiling utilities (port of ``thetis_tpu/utils/profiling.py``).

The reference wraps every model stage in ``timed_stage`` (PyOP2 timers
surfaced as ``-log_view`` events, SURVEY.md section 5.1).  Here:

* :func:`timed_stage` — a context manager that (a) opens a
  ``torch.profiler.record_function`` range, so the stage shows up as a
  named span in ``torch.profiler`` traces, and (b) accumulates host
  wall-clock per stage name.  PyTorch launches asynchronously, so the
  host timer measures enqueue time unless the stage ends in a
  synchronise; device-side attribution comes from the profiler trace.
* :func:`print_timers` / :func:`get_timers` — the ``-log_view``-style
  summary.

Capture a device trace around any region with::

    with torch.profiler.profile() as prof:
        solver.iterate()
"""
import contextlib
import time
from collections import defaultdict

__all__ = ["timed_stage", "get_timers", "reset_timers", "print_timers"]

_timers = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def timed_stage(name):
    """Named stage: profiler range + host wall-clock accumulation."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function(str(name)):
        yield
    dt = time.perf_counter() - t0
    rec = _timers[str(name)]
    rec[0] += dt
    rec[1] += 1


def get_timers():
    """{stage: (total_seconds, calls)}."""
    return {k: tuple(v) for k, v in _timers.items()}


def reset_timers():
    _timers.clear()


def print_timers():
    """-log_view style summary."""
    from .log import print_output

    if not _timers:
        print_output("timed_stage: no stages recorded")
        return
    width = max(len(k) for k in _timers)
    print_output(f"{'stage'.ljust(width)}   total [s]   calls   per-call")
    for k, (tot, n) in sorted(_timers.items(), key=lambda kv: -kv[1][0]):
        print_output(
            f"{k.ljust(width)}   {tot:9.3f}   {n:5d}   {tot / max(n, 1):8.4f}"
        )
