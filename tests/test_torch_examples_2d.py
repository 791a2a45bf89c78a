"""The repo's 2D examples (``examples/*/`` on ``FlowSolver2d``; the
inversions below) through the port, from their own source, on the CPU in
f64 (``chip_smoke.run_script``: the script rewritten by
``chip_smoke.REWRITE_TABLE``, nothing else): each passes its own checks;
``channel2d`` and ``balzano`` also match ``thetis_tpu`` (CPU, x64) field
by field in tier-1, the others in ``slow``.  The meander fails at
regression size in the reference (``ValueError: dstar value less than
1`` at the sediment model's constructor: with no morphological viscosity
set, the model takes the example's horizontal viscosity, 5e-2 m^2/s, as
the water's, and its 1 mm grains' dimensionless diameter is 0.019); the
port fails it the same way.

The repo's three inversion examples (channel friction, headland
friction, the Tohoku source) run through the port too (their ``jax.jit``
of a step is the step, their jnp source models torch functions that the
adjoint differentiates), each passing its own checks; each also runs
through ``thetis_tpu`` in ``slow``, and the records of its truth run and
its cost functionals match the port's.  The port's runs take ~1-3 min
on one CPU thread (8, 5 x 2 and 6 + 2 L-BFGS-B iterations of gradients
through the CN solve): all in ``slow`` but the channel inversion.

Tolerance: rtol 1e-9 of each field's scale (``test_torch_demos.py``),
1e-7 for the two NH scripts and 1e-4 for the tidal array
(:data:`PARITY_RTOL`, with the reasons).  The inversions: the truth
run's station records to 1e-9 of the largest record of all stations (a
station near a node of the wave records ~1e-8 m); the first cost
functional to 1e-9 and the last to 1e-6 (L-BFGS-B's line search takes
the gradients' roundoff-level differences into its steps)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from test_torch_demos import (  # noqa: E402,F401
    RTOL, assert_fields_match, assert_finite, keep_constants,
    one_torch_thread, run_port, run_reference, script_params)

SLOW = (pytest.mark.slow,)
#: the 2D examples; ``slow`` where the port's run takes over ~17 s on one
#: CPU thread (the tidal array ~9 min, gray_scott ~3.5 min), to keep the
#: file's tier-1 share near 100 s with a cold ``.jax_cache/``
SCRIPTS = {
    "examples/balzano/balzano.py": (),
    "examples/channel2d/channel2d.py": (),
    "examples/cylinder_eddies/cylinder_eddies.py": SLOW,
    "examples/discrete_turbines/tidal_array.py": SLOW,
    "examples/geostrophicGyre/geoGyre2d.py": SLOW,
    "examples/nonhydrostatic_cases/solitary_wave_nh/solitary_wave_2d.py":
        SLOW,
    "examples/nonhydrostatic_cases/standing_wave_nh/standing_wave_2d.py": (),
    "examples/north_sea/north_sea.py": SLOW,
    "examples/reaction/gray_scott.py": SLOW,
    "examples/sediment_meander_2d/meander_example.py": (),
    "examples/sediment_trench_2d/trench_example.py": SLOW,
    "examples/stommel2d/stommel2d.py": SLOW,
    "examples/tidal_barrage/lagoon2d.py": (),
    "examples/tidalfarm/tidalfarm.py": SLOW,
    "examples/waveEq2d/channel2d_waveEq.py": (),
    "examples/williamson2/williamson2.py": (),
}
#: held to the reference in tier-1; the others in ``slow``
PARITY = ("examples/balzano/balzano.py", "examples/channel2d/channel2d.py")
#: scripts the reference fails at regression size (ROADMAP C)
REFERENCE_FAILS = (chip_smoke.MEANDER,)
#: held to another tolerance than ``test_torch_demos.RTOL``: the NH
#: Poisson solve is BiCGStab stopped at ``q_solver_rtol`` 1e-8 of its
#: residual, so the two packages' iterates part at ~1e-8 (measured:
#: 1.1e-8 of q in the solitary wave, 2.9e-8 of uv in the standing wave)
NH_RTOL = 1e-7
#: the tidal array's CN solve at dt 50 s (wave CFL ~110, the Schur
#: fieldsplit) ends at its iteration cap, 8.3e-2 of its right-hand side
#: after 4 FGMRES cycles, in f64 too (ROADMAP C), so nothing damps the
#: two packages' summation-order differences: measured 2.5e-5 of uv and
#: 2.1e-5 of the elevation's scale after 20 steps
TIDAL_ARRAY_RTOL = 1e-4
PARITY_RTOL = {
    "examples/nonhydrostatic_cases/solitary_wave_nh/solitary_wave_2d.py":
        NH_RTOL,
    "examples/nonhydrostatic_cases/standing_wave_nh/standing_wave_2d.py":
        NH_RTOL,
    "examples/discrete_turbines/tidal_array.py": TIDAL_ARRAY_RTOL}


@pytest.mark.parametrize("script", script_params(SCRIPTS))
def test_example_runs_through_the_port(script):
    if script in REFERENCE_FAILS:
        ns = {}
        with pytest.raises(Exception) as e:
            run_port(script, ns)
        assert chip_smoke.fails_as_the_reference(script, e.value, ns)
    else:
        assert_finite(run_port(script).solvers)


@pytest.mark.parametrize("script", script_params(
    {p: m for p, m in SCRIPTS.items() if p not in REFERENCE_FAILS}, PARITY))
def test_example_matches_the_reference(script, tmp_path):
    ref = run_reference(script, tmp_path).solvers
    assert_fields_match(run_port(script).solvers, ref,
                        PARITY_RTOL.get(script, RTOL))


@pytest.mark.parametrize("script", REFERENCE_FAILS)
def test_example_fails_as_the_reference(script, tmp_path):
    """Both packages stop at the same error, at the same point."""
    ref_ns, port_ns = {}, {}
    with pytest.raises(Exception) as ref:
        run_reference(script, tmp_path, ref_ns)
    with pytest.raises(Exception) as port:
        run_port(script, port_ns)
    assert chip_smoke.fails_as_the_reference(script, ref.value, ref_ns)
    assert type(port.value) is type(ref.value)
    assert str(port.value) == str(ref.value)


#: the inversion examples
INVERSION_SCRIPTS = {
    "examples/channel_inversion/inverse_problem.py": (),
    "examples/headland_inversion/inverse_problem.py": SLOW,
    "examples/tohoku_inversion/inverse_problem.py": SLOW,
}


@pytest.mark.parametrize("script", script_params(INVERSION_SCRIPTS))
def test_inversion_runs_through_the_port(script):
    ns = run_port(script).namespace
    assert np.isfinite(ns["J1"]) and ns["J1"] < ns["J0"]


@pytest.mark.slow
@pytest.mark.parametrize("script", sorted(INVERSION_SCRIPTS))
def test_inversion_matches_the_reference(script, tmp_path):
    ref = run_reference(script, tmp_path).namespace
    port = run_port(script).namespace
    scale = max(np.abs(np.asarray(v)).max() for v in ref["samples"].values())
    for name, want in ref["samples"].items():
        err = np.abs(np.asarray(port["samples"][name]) - np.asarray(want))
        assert err.max() <= 1e-9 * scale, name
    assert abs(port["J0"] - ref["J0"]) <= 1e-9 * abs(ref["J0"])
    assert abs(port["J1"] - ref["J1"]) <= 1e-6 * abs(ref["J1"])
