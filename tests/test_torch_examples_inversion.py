"""The repo's three inversion examples (channel friction, headland
friction, the Tohoku source) through the port, from their own source, on
the CPU in f64 (``chip_smoke.run_script``: the script rewritten by
``chip_smoke.REWRITE_TABLE``, nothing else; its ``jax.jit`` of a step is
the step, its jnp source models torch functions that the adjoint
differentiates): each passes its own checks.  Each also runs through
``thetis_tpu`` (CPU, x64) in ``slow``, and the records of its truth run
and its cost functionals match the port's.

The port's runs take ~1-3 min on one CPU thread (8, 5 x 2 and 6 + 2
L-BFGS-B iterations of gradients through the CN solve): all in ``slow``
but the channel inversion.

Tolerance: the truth run's station records to 1e-9 of the largest
record of all stations (the forward solves, as in
``test_torch_demos.py``; a station near a node of the wave records
~1e-8 m); the first cost
functional to 1e-9 and the last to 1e-6 (L-BFGS-B's line search takes
the gradients' roundoff-level differences into its steps)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_demos import (  # noqa: E402,F401
    keep_constants, one_torch_thread, run_port, run_reference, script_params)

SLOW = (pytest.mark.slow,)
SCRIPTS = {
    "examples/channel_inversion/inverse_problem.py": (),
    "examples/headland_inversion/inverse_problem.py": SLOW,
    "examples/tohoku_inversion/inverse_problem.py": SLOW,
}


@pytest.mark.parametrize("script", script_params(SCRIPTS))
def test_inversion_runs_through_the_port(script):
    ns = run_port(script).namespace
    assert np.isfinite(ns["J1"]) and ns["J1"] < ns["J0"]


@pytest.mark.slow
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_inversion_matches_the_reference(script, tmp_path):
    ref = run_reference(script, tmp_path).namespace
    port = run_port(script).namespace
    scale = max(np.abs(np.asarray(v)).max() for v in ref["samples"].values())
    for name, want in ref["samples"].items():
        err = np.abs(np.asarray(port["samples"][name]) - np.asarray(want))
        assert err.max() <= 1e-9 * scale, name
    assert abs(port["J0"] - ref["J0"]) <= 1e-9 * abs(ref["J0"])
    assert abs(port["J1"] - ref["J1"]) <= 1e-6 * abs(ref["J1"])
