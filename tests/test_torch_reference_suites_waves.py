"""The reference's 2D demo and standing-wave test files, through
``thetis_tpu_torch`` on the CPU in f64, each test under the reference
test's own name and bounds:

* ``tests/test_multiple_tracers.py``: ``demos/demo_2d_multiple_tracers.py``
  from its source at regression size (``chip_smoke.run_script``);
* ``tests/test_standing_wave.py``: one period of the closed channel's
  standing wave, fully implicit CrankNicolson at 10, 20 and 40 steps and
  PressureProjectionPicard on dg-cg at 20 (``slow``: ~110 s on the CPU,
  where the CN cases take 8-18 s)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch import solver2d  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def cpu_mesh(cls, *args, **kw):
    return cls(*args, device="cpu", dtype=F64, **kw)


# -- tests/test_multiple_tracers.py -----------------------------------------
def test_multiple_tracers_demo():
    """``demos/demo_2d_multiple_tracers.py`` from its source at regression
    size (``chip_smoke.run_script``): three tracers bounded, the velocity
    of the tracer-only run untouched."""
    so = chip_smoke.run_script("demos/demo_2d_multiple_tracers.py", "cpu",
                               F64).namespace["solver_obj"]
    for label in ("bell_2d", "cone_2d", "slot_cyl_2d"):
        q = so.fields[label].data.numpy()
        assert np.isfinite(q).all()
        assert q.min() > 0.5 and q.max() < 2.5
    assert float(so.asm.norm_l2(so.fields.uv_2d.data)) == pytest.approx(
        0.4082, abs=1e-3)


# -- tests/test_standing_wave.py --------------------------------------------
@pytest.mark.parametrize("timesteps,max_rel_err,stepper", [
    (10, 0.02, "CrankNicolson"), (20, 5e-3, "CrankNicolson"),
    (40, 1.25e-3, "CrankNicolson"),
    pytest.param(20, 5e-3, "PressureProjectionPicard",
                 marks=pytest.mark.slow)])
def test_standing_wave_channel(timesteps, max_rel_err, stepper):
    """One period of the closed channel's standing wave (100 x 1, 100 m):
    the relative L2 error under the reference's bound at each step
    count; CN fully implicit, PPP on dg-cg as the reference runs it."""
    lx, ly, depth = 5e3, 1e3, 100.0
    mesh2d = cpu_mesh(T.RectangleMesh, 100, 1, lx, ly)
    c = math.sqrt(float(T.physical_constants["g_grav"]) * depth)
    dt = 2 * lx / c / timesteps
    so = solver2d.FlowSolver2d(
        mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(depth))
    o = so.options
    o.timestep = dt
    o.simulation_export_time = dt * timesteps
    o.simulation_end_time = 2 * lx / c - 0.1 * dt
    o.no_exports = True
    o.swe_timestepper_type = stepper
    if stepper == "CrankNicolson":
        o.swe_timestepper_options.use_semi_implicit_linearization = False
    else:
        o.element_family = "dg-cg"
    so.create_function_spaces()
    h_2d = so.function_spaces.H_2d
    so.assign_initial_conditions(elev=T.Function(h_2d).interpolate(
        lambda x, y: torch.cos(math.pi * x / lx)))
    so.iterate()
    diff = so.fields.elev_2d.data - T.Function(h_2d).interpolate(
        lambda x, y: torch.cos(math.pi * x / lx)).data
    norm = (so.eq_sw.norm_elev(diff) if stepper == "PressureProjectionPicard"
            else so.asm.norm_l2(diff))
    rel_err = float(norm) / math.sqrt(lx * ly)
    print(f"port standing wave {stepper} x{timesteps}: {rel_err:.3e}")
    assert rel_err < max_rel_err
