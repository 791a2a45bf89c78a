"""The repo's 3D examples (``examples/*/`` on ``FlowSolver``) through the
port, from their own source, on the CPU in f64 (``chip_smoke.run_script``:
the script rewritten by ``chip_smoke.REWRITE_TABLE``, nothing else): each
passes its own checks; ``channel3d_waveEq`` also matches ``thetis_tpu``
(CPU, x64) field by field in tier-1 (the cheapest reference 3D compile;
``test_torch_demos.py`` holds ``demo_3d_channel`` there), the others in
``slow``.  The lock
exchange fails at regression size in the reference: in its 50 steps the
cold bottom front does not leave the midline (``front_x`` = lx/2 = 32
km), so its last assert fails; the port fails it the same way, and in
``slow`` at the same front and fields.

Tolerance: rtol 1e-9 of each field's scale (``test_torch_demos.py``);
two longer GLS runs 1e-6 and ROFI 1e-4 (:data:`PARITY_RTOL`, with the
reasons)."""
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from test_torch_demos import (  # noqa: E402,F401
    RTOL, assert_fields_match, assert_finite, keep_constants,
    one_torch_thread, run_port, run_reference, script_params)

SLOW = (pytest.mark.slow,)
#: the 3D examples; ``slow`` where the port's run takes over ~20 s on one
#: CPU thread (the file's tier-1 share stays near 100 s with a cold
#: ``.jax_cache/``: a reference 3D compile takes ~40-110 s)
SCRIPTS = {
    "examples/baroclinic_channel/baroclinic_channel.py": (),
    "examples/baroclinic_eddies/baroclinic_eddies.py": (),
    "examples/bottomFriction/ekman_bottom.py": (),
    "examples/bottomFriction/ekman_surface.py": (),
    "examples/bottomFriction/steadyChannel.py": (),
    "examples/channel3d/channel3d.py": SLOW,
    "examples/columbia_plume/cre_plume.py": (),
    "examples/dome/dome.py": SLOW,
    "examples/freshwaterCylinder/freshwaterCylinder.py": (),
    "examples/idealizedEstuary/warnerEstuary.py": (),
    "examples/katophillips/katophillips.py": (),
    "examples/lockExchange/lockExchange.py": (),
    "examples/overflow/overflow.py": (),
    "examples/rhineROFI/rhineROFI.py": (),
    "examples/stommel3d/stommel3d.py": SLOW,
    "examples/tracerBox/tracerBox3d.py": (),
    "examples/waveEq3d/channel3d_waveEq.py": (),
}
#: held to the reference in tier-1; the others in ``slow``
PARITY = ("examples/waveEq3d/channel3d_waveEq.py",)
#: scripts the reference fails at regression size (ROADMAP C)
REFERENCE_FAILS = (chip_smoke.LOCK_EXCHANGE,)
#: held to other tolerances than ``test_torch_demos.RTOL``.  The GLS
#: closure amplifies summation-order roundoff step by step (its powers,
#: floors and limiter; ``test_torch_3d_gls.py`` holds three steps to
#: 1e-8): measured 3.0e-8 of uv_3d in the Columbia plume (8 steps) and
#: 8.4e-8 of nu_v in the estuary (54 steps).  ROFI starts with salinity
#: uniform in the vertical, where the sign of the buoyancy flux is
#: roundoff and picks the closure's c3 (ROADMAP C: a 1e-15 change moves
#: nu_v by ~4e-5 of its scale): measured 2.7e-5 of mu_v in 10 steps.
GLS_RTOL = 1e-6
ROFI_RTOL = 1e-4
PARITY_RTOL = {"examples/columbia_plume/cre_plume.py": GLS_RTOL,
               "examples/idealizedEstuary/warnerEstuary.py": GLS_RTOL,
               "examples/rhineROFI/rhineROFI.py": ROFI_RTOL}


@pytest.mark.parametrize("script", script_params(SCRIPTS))
def test_example_runs_through_the_port(script):
    ns, solvers = {}, []
    if script in REFERENCE_FAILS:
        with pytest.raises(Exception) as e:
            run_port(script, ns, solvers)
        assert chip_smoke.fails_as_the_reference(script, e.value, ns)
    else:
        run_port(script, ns, solvers)
    assert solvers
    assert_finite(solvers)


@pytest.mark.parametrize("script", script_params(
    {p: m for p, m in SCRIPTS.items() if p not in REFERENCE_FAILS}, PARITY))
def test_example_matches_the_reference(script, tmp_path):
    ref = run_reference(script, tmp_path).solvers
    assert_fields_match(run_port(script).solvers, ref,
                        PARITY_RTOL.get(script, RTOL))


@pytest.mark.slow
@pytest.mark.parametrize("script", REFERENCE_FAILS)
def test_example_fails_as_the_reference(script, tmp_path):
    """Both packages stop at the same assert with the front at the same
    place and the same fields."""
    ref_ns, port_ns, ref, port = {}, {}, [], []
    with pytest.raises(AssertionError):
        run_reference(script, tmp_path, ref_ns, ref)
    with pytest.raises(AssertionError):
        run_port(script, port_ns, port)
    assert port_ns["front_x"] == ref_ns["front_x"] == ref_ns["lx"] / 2
    assert_fields_match(port, ref)
