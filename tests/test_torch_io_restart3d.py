"""3D restarts through HDF5 checkpoints, ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU), on ``tests/test_checkpoint.py``'s 3D case
(RectangleMesh(8, 2) x 4 layers, the reference's default coupling with
the 2D mode split, dt 30 s, an export every 300 s, a Gaussian elevation
and a temperature ramp):

* the port restarted at export 2 (t = 600 s) against its uninterrupted
  run to 1200 s: bit for bit on every field the reference's test holds
  (``np.array_equal``), and the export series at the uninterrupted run's
  indices and times;
* the port restarted from the reference's checkpoint files against the
  reference's uninterrupted run, and the reference (the same solver
  object) restarted from the port's files against the port's: 1e-10;
* under LeapFrogAM3, whose history is not in the checkpoint (both
  packages reseed it from the restored fields), how far the restart lands
  from the uninterrupted run: the port's distance per field against the
  reference's, recorded in ``LEAPFROG_DISTANCE`` (1e-6 relative: the two
  agree to ~1e-8); the ``slow`` test measures the reference's again (its
  LeapFrogAM3 compile takes ~2 minutes on the CPU).

The reference compiles its advance once in the tier-1 tests."""
import glob
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from test_torch_mesh_builders import (  # noqa: E402
    pin_mesh_builders, strong_fields)

pin_mesh_builders()

from thetis_tpu import Function as JFunction  # noqa: E402
from thetis_tpu import FunctionSpace as JSpace  # noqa: E402
from thetis_tpu import RectangleMesh as JRect  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TSpace)
from thetis_tpu_torch.mesh.generation import (  # noqa: E402
    RectangleMesh as TRect)
from thetis_tpu_torch.model.flowsolver3d import (  # noqa: E402
    FlowSolver as TFlow)

F64 = torch.float64
LX = 20e3
KEYS = ("elev_2d", "uv_2d", "uv_3d", "salt_3d", "temp_3d",
        "split_residual_2d")
SERIES = [(i, 300.0 * i, 10 * i) for i in range(5)]
#: max|restart - uninterrupted| / max|uninterrupted| at 1200 s after a
#: LeapFrogAM3 restart at 600 s, measured with thetis_tpu (f64, CPU)
LEAPFROG_DISTANCE = {
    "elev_2d": 4.4899450700562826e-07, "uv_2d": 7.037192841973055e-07,
    "uv_3d": 1.1394169999357488e-04, "salt_3d": 3.2481953634747404e-15,
    "temp_3d": 1.8182022420764793e-06,
    "split_residual_2d": 1.193678298233131e-05}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(so, outdir, t_end, options):
    o = so.options
    o.timestep = 30.0
    o.simulation_export_time = 300.0
    o.simulation_end_time = t_end
    o.output_directory = str(outdir)
    o.fields_to_export = []
    for k, v in options.items():
        setattr(o, k, v)


def port_solver(outdir, t_end, **options):
    """test_checkpoint.py::make_solver3d through the port."""
    mesh = TRect(8, 2, LX, 4e3, device="cpu", dtype=F64)
    P1 = TSpace(mesh, "CG", 1)
    so = TFlow(mesh, TFunction(P1).assign(20.0), 4)
    setup(so, outdir, t_end, options)
    elev0 = TFunction(P1).interpolate(
        lambda x, y: 0.4 * torch.exp(-(((x - LX / 2) / 3e3) ** 2)))
    t0 = TFunction(TSpace(mesh, "DG", 1)).interpolate(
        lambda x, y: 10.0 + 2.0 * x / LX)
    so.assign_initial_conditions(elev=elev0, temp=t0.data, salt=35.0)
    return so


def ref_solver(outdir, t_end, **options):
    mesh = JRect(8, 2, LX, 4e3)
    P1 = JSpace(mesh, "CG", 1)
    so = JFlow(mesh, JFunction(P1).assign(20.0), 4)
    setup(so, outdir, t_end, options)
    elev0 = JFunction(P1).interpolate(
        lambda x, y: 0.4 * np.exp(-(((x - LX / 2) / 3e3) ** 2)))
    t0 = JFunction(JSpace(mesh, "DG", 1)).interpolate(
        lambda x, y: 10.0 + 2.0 * x / LX)
    so.assign_initial_conditions(elev=elev0, temp=t0.data, salt=35.0)
    return so


def series(outdir):
    out = []
    for f in sorted(glob.glob(os.path.join(str(outdir), "hdf5",
                                           "Elevation2d_*.h5"))):
        with h5py.File(f) as h:
            out.append((int(f[-8:-3]), float(h.attrs["time"]),
                        int(h.attrs["iteration"])))
    return out


def fields(so):
    return {k: np.array(so.fields[k].data) for k in KEYS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("restart3d")
    r = {}
    full = port_solver(d / "port_full", 1200.0)
    full.iterate()
    r["port_full"] = fields(full)
    port_solver(d / "port_restart", 600.0).iterate()
    b = port_solver(d / "port_restart", 1200.0)
    b.load_state(2)
    r["port_restart_time"] = b.simulation_time
    b.iterate()
    r["port_restart"] = fields(b)
    r["port_series"] = (series(d / "port_full"), series(d / "port_restart"))
    js = ref_solver(d / "ref", 1200.0)
    strong_fields(js)  # one compile of the reference's advance, not two
    js.iterate()
    r["ref_full"] = fields(js)
    r["ref_series"] = series(d / "ref")
    c = port_solver(d / "port_from_ref", 1200.0)
    c.load_state(2, outputdir=str(d / "ref"))
    c.iterate()
    r["port_from_ref"] = fields(c)
    js.load_state(2, outputdir=str(d / "port_full"))
    js.iterate()
    r["ref_from_port"] = fields(js)
    return r


@pytest.mark.parametrize("key", KEYS)
def test_port_3d_restart_is_bit_exact(runs, key):
    assert runs["port_restart_time"] == 600.0
    assert np.array_equal(runs["port_restart"][key], runs["port_full"][key])


def test_port_3d_restart_continues_the_export_series(runs):
    assert runs["port_series"] == (SERIES, SERIES)
    assert runs["ref_series"] == SERIES


@pytest.mark.parametrize("key", KEYS)
def test_3d_checkpoints_cross_between_the_packages(runs, key):
    assert np.allclose(runs["port_from_ref"][key], runs["ref_full"][key],
                       atol=1e-10, rtol=0)
    assert np.allclose(runs["ref_from_port"][key], runs["port_full"][key],
                       atol=1e-10, rtol=0)


def leapfrog_distance(make, d):
    """Per field, max|restart - uninterrupted| / max|uninterrupted| of a
    LeapFrogAM3 run to 1200 s restarted at export 2 (600 s)."""
    lf = dict(timestepper_type="LeapFrogAM3")
    full = make(d / "full", 1200.0, **lf)
    full.iterate()
    ref = fields(full)
    full.load_state(2)
    full.iterate()
    got = fields(full)
    return {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in KEYS}


def same_distance(dist):
    """Each field's distance is the recorded one; salinity, uniform at the
    start, stays at roundoff in both."""
    for k in KEYS:
        if LEAPFROG_DISTANCE[k] < 1e-12:
            assert dist[k] < 1e-12, k
        else:
            assert dist[k] == pytest.approx(LEAPFROG_DISTANCE[k],
                                            rel=1e-6), k


def test_leapfrog_restart_lands_where_the_reference_s_does(tmp_path):
    dist = leapfrog_distance(port_solver, tmp_path)
    same_distance(dist)
    assert dist["uv_3d"] > 1e-5  # the reseeded history is not exact


@pytest.mark.slow
def test_leapfrog_distance_of_the_reference(tmp_path):
    same_distance(leapfrog_distance(ref_solver, tmp_path))
