"""The partition tables of ``thetis_tpu_torch.parallel`` against the
reference's, array for array (host numpy; no compile): ``StripePartition``
and ``HaloPartition`` with each SubMesh's tables, the halo rows that
``halo_extend`` gathers, the scatter / gather round trip, and the
reference's refusals (a periodic-x mesh, a cell count the partition count
does not divide, a 2-ring halo that spans more than one stripe)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.parallel.partition import (  # noqa: E402
    StripePartition as JStripe)
from thetis_tpu.parallel.submesh import HaloPartition as JHalo  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.parallel import shard  # noqa: E402
from thetis_tpu_torch.parallel.partition import (  # noqa: E402
    StripePartition as TStripe)
from thetis_tpu_torch.parallel.submesh import (  # noqa: E402
    HaloPartition as THalo, SubMesh)

#: (nx, ny, partitions): the reference tests' meshes and the bench's 4
CASES = [(16, 4, 8), (16, 8, 8), (16, 8, 4), (16, 8, 1), (12, 6, 3)]
SUBMESH_TABLES = ("coords_np", "cells_np", "detJ_np", "Jinv_np",
                  "cell_area_np", "cell_hmin_np", "cell_hmax_np",
                  "facet_cells_np", "facet_variant_np", "facet_normal_np",
                  "facet_len_np", "facet_l_normal_np", "facet_marker_np",
                  "facet_is_boundary_np", "facet_local_np", "facet_verts_np",
                  "cell_facets_np", "cell_sides_np")


def meshes(nx, ny):
    return (jgen.RectangleMesh(nx, ny, 8e3, 2e3),
            tgen.RectangleMesh(nx, ny, 8e3, 2e3, device="cpu"))


def equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("nx,ny,D", CASES)
def test_stripe_partition_tables(nx, ny, D):
    jm, tm = meshes(nx, ny)
    jp, tp = JStripe(jm, D), TStripe(tm, D)
    assert (jp.n_loc, jp.halo, jp.n_facets_local) == (
        tp.n_loc, tp.halo, tp.n_facets_local)
    assert equal(jp.perm, tp.perm)
    assert sorted(jp.tables) == sorted(tp.tables)
    for k in jp.tables:
        assert equal(jp.tables[k], tp.tables[k]), k


@pytest.mark.parametrize("nx,ny,D", CASES)
def test_halo_partition_tables(nx, ny, D):
    jm, tm = meshes(nx, ny)
    jp, tp = JHalo(jm, D), THalo(tm, D, devices=["cpu"] * D)
    assert (jp.n_loc, jp.halo, jp.n_ext, jp.n_facets_local) == (
        tp.n_loc, tp.halo, tp.n_ext, tp.n_facets_local)
    for k in ("perm", "inv_perm", "ext_ids", "send_left", "send_right",
              "vert_ids"):
        assert equal(getattr(jp, k), getattr(tp, k)), k
    for js, ts in zip(jp.submeshes, tp.submeshes):
        assert isinstance(ts, SubMesh)
        assert (js.nv, js.nc, js.nf, js.name) == (ts.nv, ts.nc, ts.nf,
                                                  ts.name)
        for k in SUBMESH_TABLES:
            assert equal(getattr(js, k), getattr(ts, k)), k
        # global per-marker lengths and markers (submesh.py:37-40)
        assert js.boundary_markers == ts.boundary_markers
        assert js.boundary_len == ts.boundary_len
        # the device tensors are the host tables
        assert ts.device == torch.device("cpu") and ts.dtype == tm.dtype
        assert np.array_equal(ts.facet_cells.numpy(), ts.facet_cells_np)
        assert np.array_equal(ts.Jinv.numpy(), ts.Jinv_np)
        assert np.array_equal(ts.facet_is_interior.numpy(),
                              ~ts.facet_is_boundary_np)


@pytest.mark.parametrize("nx,ny,D", CASES)
def test_halo_rows_are_the_reference_slots(nx, ny, D):
    """The striped rows that ``halo_extend`` gathers for a partition back
    the reference's extended slots (``ext_ids``), and the ghost rows are
    the neighbours' owned rows."""
    _, tm = meshes(nx, ny)
    tp = THalo(tm, D, devices=["cpu"] * D)
    cell_ids = torch.as_tensor(tp.perm.astype(np.int64))[:, None]
    for d in range(D):
        rows = shard._ext_rows(tp.send_left, tp.send_right, tp.n_loc, d)
        assert np.array_equal(tp.perm[rows], tp.ext_ids[d])
        owner = rows // tp.n_loc
        H = tp.halo
        assert (owner[tp.n_loc:tp.n_loc + H] == (d - 1) % D).all()
        assert (owner[tp.n_loc + H:] == (d + 1) % D).all()
        ext = shard.halo_extend(tp, cell_ids, d)[:, 0].numpy()
        assert np.array_equal(ext, tp.ext_ids[d])
        # the Krylov container: (D, k, n_loc) -> (k, n_ext)
        blocked = cell_ids[:, 0].reshape(D, 1, tp.n_loc).repeat(1, 2, 1)
        ext_b = shard.halo_extend(tp, blocked, d, blocked=True)
        assert ext_b.is_contiguous() and tuple(ext_b.shape) == (2, tp.n_ext)
        assert np.array_equal(ext_b[1].numpy(), tp.ext_ids[d])


@pytest.mark.parametrize("cls", ["stripe", "halo"])
def test_scatter_gather_round_trip(cls):
    _, tm = meshes(16, 8)
    part = (TStripe(tm, 8) if cls == "stripe"
            else THalo(tm, 8, devices=["cpu"] * 8))
    u = np.random.RandomState(0).rand(tm.nc, 3, 2)
    assert np.array_equal(part.gather_cells(part.scatter_cells(u)), u)
    if cls == "halo":
        v = np.random.RandomState(1).rand(tm.nv)
        jp = JHalo(meshes(16, 8)[0], 8)
        assert equal(part.local_cell_values(u), jp.local_cell_values(u))
        assert equal(part.local_vertex_values(v), jp.local_vertex_values(v))


def test_refusals_are_the_reference():
    """Both packages refuse the same partitions, with the same error."""
    for pkg, part in (("ref", JHalo), ("port", THalo)):
        gen = jgen if pkg == "ref" else tgen
        kw = {} if pkg == "ref" else dict(device="cpu")
        periodic = gen.PeriodicRectangleMesh(16, 4, 8e3, 2e3,
                                             direction="x", **kw)
        with pytest.raises(AssertionError, match="periodic-x"):
            part(periodic, 8)
        rect = gen.RectangleMesh(16, 4, 8e3, 2e3, **kw)
        with pytest.raises(AssertionError, match="must divide"):
            part(rect, 5)
        with pytest.raises(AssertionError, match="spans >1 stripe"):
            part(rect, 32)


def test_partition_devices():
    _, tm = meshes(16, 4)
    assert shard.make_device_mesh(3, ["cpu"] * 4) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        shard.make_device_mesh(4, ["cpu"] * 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            shard.make_device_mesh(2)
    with pytest.raises(ValueError, match="devices for"):
        THalo(tm, 8, devices=["cpu"] * 4)
    # by default the partitions go where the mesh is
    assert THalo(tm, 8).devices == [tm.device] * 8


def test_sharded_exports_make_device_mesh():
    """``parallel.sharded.make_device_mesh``, as the reference's
    ``sharded.py`` defines it beside ``shard.py``'s: the same function."""
    from thetis_tpu_torch.parallel import sharded
    assert sharded.make_device_mesh is shard.make_device_mesh
    assert sharded.make_device_mesh(2, ["cpu"] * 2) == [torch.device("cpu")] * 2


def test_allreduce_sums_in_partition_order():
    parts = torch.tensor([1e16, 1.0, -1e16, 1.0], dtype=torch.float64)
    assert float(shard.allreduce(parts)) == ((1e16 + 1.0) - 1e16) + 1.0
    rows = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(shard.allreduce(rows), rows.sum(0))
    assert torch.equal(shard.allreduce([rows[0], rows[1]]), rows[0] + rows[1])
