"""``FlowSolver2d`` of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64,
CPU): 3 steps of each time stepper and solver configuration, entered as a
user enters the model (``FlowSolver2d(mesh, bathymetry)``, ``.options``,
``bnd_functions``, ``assign_initial_conditions``, ``iterate()``).  The
reference solver is built from seeded numpy inputs and the port's is
carried over from it by ``interop.flowsolver2d_from_reference``.

Meshes: a 12x6 rectangle with an ``elev`` boundary on marker 1 and land
elsewhere, and an x-periodic rectangle (land top and bottom); sloped CG1
bathymetry.  Tolerances: explicit steppers rtol 1e-12, implicit ones
1e-9, each with an atol of the same factor times the field's max (the
Krylov solves iterate roundoff; both packages take the same Krylov
path)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JSolver  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the meshes are tiny, so
    torch's CPU thread pool only adds synchronisation, which under
    parallel test workers on shared cores costs more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LX, LY = 1e4, 5e3
C0 = np.sqrt(9.81 * 25.0)   # the deepest wave speed
HMIN = LX / 12               # both meshes' smallest edge

#: name -> (stepper, semi-implicit linearization, dt, expected coarse PC)
CONFIGS = {
    "ssprk33": ("SSPRK33", None, 0.2 * HMIN / C0, None),
    "forward_euler": ("ForwardEuler", None, 0.1 * HMIN / C0, None),
    # the policy's rest-state implicit wave CFL: theta dt sqrt(g H)/hmin
    "cn_semi_implicit": ("CrankNicolson", True, 2.0 * HMIN / C0, "NoneType"),
    "cn_newton": ("CrankNicolson", False, 2.0 * HMIN / C0, None),
    "backward_euler": ("BackwardEuler", True, 1.5 * HMIN / C0, "NoneType"),
    "cn_coarse": ("CrankNicolson", True, 12.0 * HMIN / C0,
                  "CoarseCorrection"),
    "cn_schur": ("CrankNicolson", True, 50.0 * HMIN / C0,
                 "SchurFieldsplitPC"),
}


def meshes(kind):
    if kind == "rect":
        return (jgen.RectangleMesh(12, 6, LX, LY),
                tgen.RectangleMesh(12, 6, LX, LY, device="cpu", dtype=F64))
    return (jgen.PeriodicRectangleMesh(12, 6, LX, LY, direction="x"),
            tgen.PeriodicRectangleMesh(12, 6, LX, LY, direction="x",
                                       device="cpu", dtype=F64))


def reference_solver(jm, kind, config, nsteps=3, dt=None, params=None):
    """The reference FlowSolver2d with seeded initial conditions
    (``params``: NewtonParameters keywords for the SWE solve)."""
    stepper, semi, dt_config, _ = CONFIGS[config]
    dt = dt_config if dt is None else dt
    bathy = 20.0 + 5.0 * jm.coords_np[:, 1] / LY
    s = JSolver(jm, bathy)
    o = s.options
    o.swe_timestepper_type = stepper
    if semi is not None:
        o.swe_timestepper_options.use_semi_implicit_linearization = semi
    else:
        o.swe_timestepper_options.use_automatic_timestep = False
    if params is not None:
        o.swe_timestepper_options.solver_parameters = JNP(**params)
    o.timestep = dt
    o.simulation_export_time = nsteps * dt
    o.simulation_end_time = nsteps * dt
    o.no_exports = True
    o.quadratic_drag_coefficient = 2.5e-3
    o.horizontal_viscosity = 1.0
    if kind == "rect":
        s.bnd_functions["shallow_water"][1] = {"elev": 0.05}
    rng = np.random.default_rng(11)
    x = jm.coords_np[jm.cells_np]
    s.assign_initial_conditions(
        elev=0.5 * np.exp(-((x[..., 0] - LX / 2) / 2e3) ** 2),
        uv=0.05 * rng.standard_normal((jm.nc, 3, 2)))
    return s


def run_pair(kind, config, params=None):
    jm, tm = meshes(kind)
    ref = reference_solver(jm, kind, config, params=params)
    port = flowsolver2d_from_reference(ref, tm)
    return ref, port


@pytest.mark.parametrize("kind,config", [
    ("rect", "ssprk33"), ("rect", "forward_euler"),
    ("rect", "cn_semi_implicit"), ("rect", "cn_newton"),
    ("periodic", "ssprk33"), ("periodic", "cn_semi_implicit"),
])
def test_three_steps_match_reference(kind, config):
    ref, port = run_pair(kind, config)
    stepper, semi, dt, coarse = CONFIGS[config]
    assert type(port.timestepper).__name__ == type(ref.timestepper).__name__
    assert port.dt == ref.dt == dt
    if coarse is not None:
        assert type(port.timestepper.coarse).__name__ == coarse
        assert type(ref.timestepper.coarse).__name__ == coarse
    if semi is False:
        assert type(port.timestepper.preconditioner).__name__ == \
            "AssembledWavePC"
    x0 = port.fields.elev_2d.data.clone()
    ref.iterate()
    port.iterate()
    assert (port.iteration, port.i_export) == (ref.iteration,
                                               ref.i_export) == (3, 1)
    assert port.simulation_time == pytest.approx(ref.simulation_time,
                                                 abs=1e-12)
    rtol = 1e-12 if semi is None else 1e-9
    for key in ("elev_2d", "uv_2d"):
        got = port.fields[key].data.numpy()
        want = np.asarray(ref.fields[key].data)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())
    # the steps moved the state: the comparison is not of two no-ops
    assert float((port.fields.elev_2d.data - x0).abs().max()) > 1e-4
    st = port.timestepper.__dict__.get("stats", {})
    if semi is True:
        assert st["ksp_cycles"] >= 1 and st["ksp_rel_residual"] < 1e-6
    elif semi is False:
        # the last Newton iteration's linear solve starts at roundoff, so
        # its own relative residual says nothing; the Newton residual does
        assert st["newton_iterations"] >= 1 and st["ksp_cycles"] >= 1
        assert st["snes_rel_residual"] <= 1e-8
