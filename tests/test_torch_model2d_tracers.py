"""2D tracers through ``FlowSolver2d`` of ``thetis_tpu_torch``, entered as
a user enters the model (options, ``bnd_functions``,
``assign_initial_conditions``, ``iterate()``), against ``thetis_tpu``
(f64, CPU).  The reference solver is built from seeded numpy inputs and
the port's is carried over by ``interop.flowsolver2d_from_reference``
(a callable source is given to both by the test).

Configurations, each two steps on an 8x4 rectangle (``elev`` boundary on
marker 1, tracer ``value`` / ``value-<label>`` boundaries):

* ``cn``: semi-implicit CN SWE (assembled) with two DG tracers on the
  default CN tracer stepper, the limiter, Lax-Friedrichs, a source, a
  field diffusivity, and the volume, tracer-mass and overshoot monitors;
* ``dirk22_picard``: DIRK22 SWE with ``tracer_picard_iterations = 2`` and
  a callable (reaction) source evaluated at each Picard iterate;
* ``tracer_only``: the SWE frozen, SSPRK33 tracers (the tracer demos'
  mode);
* ``cg_supg``: CG1 tracers with SUPG, the CG mass PCG in the CN solve.

Tolerances: 1e-9 of each field's max (the implicit steps of
``test_torch_flowsolver2d.py``); monitors' values 1e-10 relative."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JSolver  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
LX, LY = 1e4, 5e3
LABELS = ("tracer_2d", "salt_2d")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def reaction(tr):
    """A state-dependent source (the gray-scott example's kind), the same
    arithmetic on either package's arrays."""
    return -1e-4 * tr["tracer_2d"] * tr["salt_2d"]


def setup(s, config):
    o = s.options
    jm = s.mesh2d
    cg = config == "cg_supg"
    o.swe_timestepper_type = "DIRK22" if config == "dirk22_picard" \
        else "CrankNicolson"
    o.timestep = 40.0
    o.simulation_export_time = 80.0
    o.simulation_end_time = 80.0
    o.no_exports = True
    o.quadratic_drag_coefficient = 2.5e-3
    if cg:
        o.tracer_element_family = "cg"
        o.use_supg_tracer = True
        o.horizontal_velocity_scale = 0.3
    o.add_tracer_2d("tracer_2d", "Depth averaged tracer", "Tracer2d",
                    source=2e-4 if config == "cn" else None,
                    diffusivity=2.0)
    o.add_tracer_2d("salt_2d", diffusivity=(
        1.0 + jm.coords_np[:, 0] / LX if config == "cn" else None))
    o.horizontal_diffusivity = 0.5
    o.use_lax_friedrichs_tracer = config == "cn"
    o.use_limiter_for_tracers = config in ("cn", "dirk22_picard")
    if config == "dirk22_picard":
        o.tracer_picard_iterations = 2
        o.tracer["tracer_2d"].source = reaction
    if config == "tracer_only":
        o.tracer_only = True
        o.tracer_timestepper_type = "SSPRK33"
        o.timestep = 10.0
        o.simulation_export_time = 20.0
        o.simulation_end_time = 20.0
    if config == "cn":
        o.check_volume_conservation_2d = True
        o.check_tracer_conservation = True
        o.check_tracer_overshoot = True
    s.bnd_functions["shallow_water"][1] = {"elev": 0.05}
    s.bnd_functions["tracer"][1] = {"value": 1.2}
    s.bnd_functions["tracer"][2] = {"value-salt_2d": 0.3, "value": 0.9}
    rng = np.random.default_rng(17)
    x = jm.coords_np[jm.cells_np]
    if cg:
        xv = jm.coords_np
        tr = {"tracer_2d": 1.0 + 0.5 * np.exp(-((xv[:, 0] - LX / 2) / 2e3)
                                              ** 2),
              "salt_2d": 0.5 + 0.1 * rng.random(jm.nv)}
    else:
        tr = {"tracer_2d": 1.0 + 0.5 * np.exp(-((x[..., 0] - LX / 2) / 2e3)
                                              ** 2),
              "tracer": None,
              "salt_2d": 0.5 + 0.2 * rng.random((jm.nc, 3))}
        tr["tracer"] = tr.pop("tracer_2d")  # the reference's alias
    s.assign_initial_conditions(
        elev=0.3 * np.exp(-((x[..., 0] - LX / 2) / 2e3) ** 2),
        uv=0.2 + 0.05 * rng.standard_normal((jm.nc, 3, 2)), **tr)


CONFIGS = ("cn", "dirk22_picard", "tracer_only", "cg_supg")


@pytest.fixture(scope="module")
def runs():
    out = {}
    for config in CONFIGS:
        jm = jgen.RectangleMesh(8, 4, LX, LY)
        ref = JSolver(jm, 20.0 + 5.0 * jm.coords_np[:, 1] / LY)
        setup(ref, config)
        port = flowsolver2d_from_reference(
            ref, tgen.RectangleMesh(8, 4, LX, LY, device="cpu", dtype=F64))
        if config == "dirk22_picard":
            assert port.options.tracer["tracer_2d"].source is None
            port.options.tracer["tracer_2d"].source = reaction
            port._build_advance()
        start = {k: port.fields[k].data.clone() for k in LABELS}
        ref.iterate()
        port.iterate()
        out[config] = (ref, port, start)
    return out


@pytest.mark.parametrize("config", CONFIGS)
def test_iterate_matches_reference(runs, config):
    ref, port, start = runs[config]
    assert port.tracer_labels == list(LABELS) == ref.tracer_labels
    assert (port.iteration, port.i_export) == (ref.iteration, ref.i_export)
    assert port.iteration == 2
    for key in ("elev_2d", "uv_2d") + LABELS:
        close(port.fields[key].data, ref.fields[key].data, 1e-9)
    for l in LABELS:
        assert float((port.fields[l].data - start[l]).abs().max()) > 1e-4
    shape = (port.mesh2d.nv,) if config == "cg_supg" else (port.mesh2d.nc,
                                                            3)
    assert tuple(port.fields.tracer_2d.data.shape) == shape
    limiter = port.tracer_limiter
    if config in ("cn", "dirk22_picard"):
        assert type(limiter).__name__ == "VertexBasedP1DGLimiter"
    else:
        assert limiter is None
    if config == "tracer_only":
        # the flow is not stepped
        close(port.fields.elev_2d.data, np.asarray(
            ref.fields.elev_2d.data), 0.0)


def test_tracer_mass_monitor(runs):
    """The auto-attached monitors: volume, each tracer's mass (depth
    integrated) and overshoot; the mass agrees with the reference's."""
    ref, port, _ = runs["cn"]
    names = set(port.callbacks["export"])
    assert {"volume2d", "tracer_2d mass", "salt_2d mass",
            "tracer_2d overshoot", "salt_2d overshoot"} <= names
    for l in LABELS:
        m_ref = ref.compute_tracer_mass(l)
        m_port = port.compute_tracer_mass(l)
        assert m_port == pytest.approx(m_ref, rel=1e-10)
        cb = port.callbacks["export"][f"{l} mass"]
        value, rel = cb()
        assert value == pytest.approx(m_port, rel=1e-14)
        assert rel == 0.0  # the first reading is the reference value
        # the monitor reads the depth-integrated mass: doubling the
        # tracer doubles it
        data = port.fields[l].data
        port.fields[l].data = 2.0 * data
        assert cb()[1] == pytest.approx(1.0, rel=1e-12)
        port.fields[l].data = data


def test_picard_needs_a_crank_nicolson_tracer_stepper():
    tm = tgen.RectangleMesh(4, 2, LX, LY, device="cpu", dtype=F64)
    s = FlowSolver2d(tm, 20.0)
    s.options.no_exports = True
    s.options.timestep = 10.0
    s.options.add_tracer_2d("tracer_2d")
    s.options.tracer_timestepper_type = "SSPRK33"
    s.options.tracer_picard_iterations = 2
    with pytest.raises(NotImplementedError, match="CrankNicolson"):
        s.initialize()


def test_demo_2d_tracer_through_the_facade():
    """``demos/demo_2d_tracer.py`` with its import line changed to the
    port, its mesh asked for on the CPU and cut to 20x20, and its end
    time to 10 steps: solid-body rotation in tracer-only mode."""
    with open(os.path.join(ROOT, "demos", "demo_2d_tracer.py")) as f:
        src = f.read()
    for old, new in (("from thetis_tpu import *",
                      "from thetis_tpu_torch import *"),
                     ("UnitSquareMesh(40, 40)",
                      'UnitSquareMesh(20, 20, device="cpu")'),
                     ("options.simulation_end_time = t_end",
                      "options.simulation_end_time = 10 * timestep")):
        assert src.count(old) == 1
        src = src.replace(old, new)
    ns = {"__name__": "demo"}
    exec(compile(src, "demo_2d_tracer.py", "exec"), ns)
    s = ns["solver_obj"]
    assert isinstance(s, FlowSolver2d) and s.options.tracer_only
    assert s.iteration == 10
    assert 1e-4 < ns["rel_err"] < 0.2
    q = s.fields.tracer_2d.data
    assert bool(torch.isfinite(q).all())
