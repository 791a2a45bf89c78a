"""2D restarts through HDF5 checkpoints, ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU), on ``tests/test_checkpoint.py``'s 2D case
(RectangleMesh(10, 2), CrankNicolson, dt 50 s, an export every 200 s):

* the port restarted at export 2 (t = 400 s) against the port's
  uninterrupted run to 800 s: bit for bit;
* the port restarted from the reference's checkpoint files against the
  reference's uninterrupted run, and the reference restarted from the
  port's files against the port's: 1e-10, the reference test's own
  tolerance;
* the export series: the port's restart goes on at the uninterrupted
  run's indices and times; the reference's writes the restored state
  again at index 3 and shifts the rest by one (the departure listed in
  ROADMAP C, "Standing divergences"), which this file records.

The reference's uninterrupted solver also continues from the port's
files (``load_state`` on the same object, no second compile); a fresh
reference solver records its own restart."""
import glob
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

from thetis_tpu import Function as JFunction  # noqa: E402
from thetis_tpu import FunctionSpace as JSpace  # noqa: E402
from thetis_tpu import RectangleMesh as JRect  # noqa: E402
from thetis_tpu import solver2d as jsolver2d  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TSpace)
from thetis_tpu_torch.mesh.generation import (  # noqa: E402
    RectangleMesh as TRect)
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402

F64 = torch.float64
LX, LY = 40e3, 2e3
KEYS = ("elev_2d", "uv_2d")
#: (index, time, iteration) of the uninterrupted run's checkpoints
SERIES = [(i, 200.0 * i, 4 * i) for i in range(5)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(so, outdir, t_end):
    o = so.options
    o.timestep = 50.0
    o.simulation_export_time = 200.0
    o.simulation_end_time = t_end
    o.swe_timestepper_type = "CrankNicolson"
    o.output_directory = str(outdir)
    o.fields_to_export = []
    o.fields_to_export_hdf5 = list(KEYS)


def port_solver(outdir, t_end):
    """test_checkpoint.py::make_solver through the port."""
    mesh = TRect(10, 2, LX, LY, device="cpu", dtype=F64)
    P1 = TSpace(mesh, "CG", 1)
    so = FlowSolver2d(mesh, TFunction(P1).assign(20.0))
    setup(so, outdir, t_end)
    so.assign_initial_conditions(elev=TFunction(P1).interpolate(
        lambda x, y: torch.exp(-(((x - LX / 2) / 6000.0) ** 2))))
    return so


def ref_solver(outdir, t_end):
    mesh = JRect(10, 2, LX, LY)
    P1 = JSpace(mesh, "CG", 1)
    so = jsolver2d.FlowSolver2d(mesh, JFunction(P1).assign(20.0))
    setup(so, outdir, t_end)
    so.assign_initial_conditions(elev=JFunction(P1).interpolate(
        lambda x, y: np.exp(-(((x - LX / 2) / 6000.0) ** 2))))
    return so


def series(outdir):
    """(index, time, iteration) of every Elevation2d checkpoint."""
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
    d = tmp_path_factory.mktemp("restart2d")
    r = {}
    # the port: uninterrupted, and a run to 400 s restarted from export 2
    full = port_solver(d / "port_full", 800.0)
    full.iterate()
    r["port_full"] = fields(full)
    port_solver(d / "port_restart", 400.0).iterate()
    b = port_solver(d / "port_restart", 800.0)
    b.load_state(2)
    r["port_restart_time"] = b.simulation_time
    b.iterate()
    r["port_restart"] = fields(b)
    r["port_series"] = (series(d / "port_full"), series(d / "port_restart"))
    # the reference: uninterrupted, then continued from the port's files
    js = ref_solver(d / "ref", 800.0)
    js.iterate()
    r["ref_full"] = fields(js)
    r["ref_full_series"] = series(d / "ref")
    # a fresh reference solver restarted from export 2, as
    # test_checkpoint.py restarts (its first exports copied in)
    os.makedirs(d / "ref_restart" / "hdf5")
    for f in glob.glob(str(d / "ref" / "hdf5" / "*_0000[0-2].h5")):
        shutil.copy(f, d / "ref_restart" / "hdf5")
    jb = ref_solver(d / "ref_restart", 800.0)
    jb.load_state(2)
    jb.iterate()
    r["ref_restart"] = fields(jb)
    r["ref_restart_series"] = series(d / "ref_restart")
    # js has exported its initial state: its restart is the reference's
    # with the one fault patched out (the flag its 3D load_state sets)
    js.load_state(2, outputdir=str(d / "port_full"))
    js.iterate()
    r["ref_from_port"] = fields(js)
    r["ref_patched_series"] = series(d / "ref")
    # the port restarted from the reference's checkpoint files
    c = port_solver(d / "port_from_ref", 800.0)
    c.load_state(2, outputdir=str(d / "ref"))
    c.iterate()
    r["port_from_ref"] = fields(c)
    r["port_from_ref_series"] = series(d / "port_from_ref")
    return r


@pytest.mark.parametrize("key", KEYS)
def test_port_restart_is_bit_exact(runs, key):
    assert runs["port_restart_time"] == 400.0
    assert np.array_equal(runs["port_restart"][key], runs["port_full"][key])


def test_port_restart_continues_the_export_series(runs):
    full, restart = runs["port_series"]
    assert full == SERIES
    assert restart == SERIES


def test_reference_restart_writes_the_restored_state_again(runs):
    """What the reference writes: its uninterrupted series as the port's,
    and after ``load_state(2)`` the state of t = 400 s once more at index
    3 (iteration 8), then 600 s and 800 s at indices 4 and 5."""
    assert runs["ref_full_series"] == SERIES
    assert runs["ref_restart_series"] == SERIES[:3] + [
        (3, 400.0, 8), (4, 600.0, 12), (5, 800.0, 16)]
    # with ``_initial_export_done`` set, as its 3D ``load_state`` sets it,
    # the reference writes the port's series
    assert runs["ref_patched_series"] == SERIES


@pytest.mark.parametrize("key", KEYS)
def test_port_continues_the_reference_checkpoint(runs, key):
    ref = runs["ref_full"][key]
    assert np.allclose(runs["port_from_ref"][key], ref, atol=1e-10)
    assert np.allclose(runs["ref_restart"][key], ref, atol=1e-10)
    # its own series from the reference's files: 600 s and 800 s at 3, 4
    assert runs["port_from_ref_series"] == SERIES[3:]


@pytest.mark.parametrize("key", KEYS)
def test_reference_continues_the_port_checkpoint(runs, key):
    assert np.allclose(runs["ref_from_port"][key], runs["port_full"][key],
                       atol=1e-10)
