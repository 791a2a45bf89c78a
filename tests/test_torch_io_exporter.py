"""The exporters and the facade, ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): the HDF5 checkpoint files read in both
directions (f64 into f32 too, and the shape mismatch that raises), the
``mesh.h5`` and NPZ arrays, the ``.vtu``/``.pvd`` files byte for byte for
P1DG, CG1 and vector fields, ``ExportManager``'s file sets, and the
facade's math vocabulary.

Inputs are seeded numpy arrays on ``RectangleMesh(5, 3)``.  Tolerances:
files and arrays equal (the same numbers written by the same numpy
calls); a checkpoint read into f32 equals the f64 values rounded; the
math vocabulary 1e-15 relative (libm against XLA's elementwise
functions)."""
import filecmp
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

import thetis_tpu as jpkg  # noqa: E402
import thetis_tpu_torch as tpkg  # noqa: E402
from thetis_tpu.fem.functionspace import Function as JFunction  # noqa: E402
from thetis_tpu.fem.functionspace import (  # noqa: E402
    FunctionSpace as JSpace)
from thetis_tpu.mesh.generation import RectangleMesh as JRect  # noqa: E402
from thetis_tpu.model import exporter as jexp  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TSpace)
from thetis_tpu_torch.mesh.generation import (  # noqa: E402
    RectangleMesh as TRect)
from thetis_tpu_torch.model import exporter as texp  # noqa: E402
from thetis_tpu_torch.model.field_defs import FieldDict  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
SPACES = {"p1dg": ("DG", 1, 1), "cg1": ("CG", 1, 1), "vector": ("DG", 1, 2)}


class Pair:
    """The same seeded field in both packages on RectangleMesh(5, 3)."""

    def __init__(self, kind, dtype=F64, seed=0, name="elev_2d"):
        fam, deg, dim = SPACES[kind]
        self.jm = JRect(5, 3, 2.0, 1.0)
        self.tm = TRect(5, 3, 2.0, 1.0, device="cpu", dtype=dtype)
        self.jV = JSpace(self.jm, fam, deg, dim=dim)
        self.tV = TSpace(self.tm, fam, deg, dim=dim)
        shape = self.jV.dof_shape()
        self.values = np.random.default_rng(seed).standard_normal(shape)
        self.jf = JFunction(self.jV, name=name, data=jnp.asarray(self.values))
        self.tf = TFunction(self.tV, name=name, data=self.values)


def same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names, the same bytes."""
    ls = []
    for root in (a, b):
        ls.append(sorted(os.path.relpath(os.path.join(r, f), root)
                         for r, _, fs in os.walk(root) for f in fs))
    assert ls[0] == ls[1] and ls[0]
    for rel in ls[0]:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel
    return ls[0]


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_port_checkpoint_reads_in_the_reference(tmp_path, kind):
    p = Pair(kind, seed=1)
    e = texp.HDF5Exporter(p.tV, str(tmp_path), "Field")
    e.export_as_index(3, p.tf, time=150.0, iteration=7)
    back = JFunction(p.jV)
    t = jexp.HDF5Exporter(p.jV, str(tmp_path), "Field").load(3, back)
    assert t == 150.0
    assert np.array_equal(np.asarray(back.data), p.values)
    with h5py.File(tmp_path / "Field_00003.h5") as f:
        assert f.attrs["iteration"] == 7 and f.attrs["name"] == "elev_2d"


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_reference_checkpoint_reads_in_the_port(tmp_path, kind):
    p = Pair(kind, seed=2)
    jexp.HDF5Exporter(p.jV, str(tmp_path), "Field").export_as_index(
        0, p.jf, time=25.0, iteration=1)
    e = texp.HDF5Exporter(p.tV, str(tmp_path), "Field")
    back = TFunction(p.tV)
    assert e.load(0, back) == 25.0 and e.last_iteration == 1
    assert back.data.dtype == F64 and back.data.device.type == "cpu"
    assert np.array_equal(back.data.numpy(), p.values)


def test_f64_checkpoint_loads_into_an_f32_field(tmp_path):
    p = Pair("vector", seed=3)
    jexp.HDF5Exporter(p.jV, str(tmp_path), "Velocity2d").export_as_index(
        0, p.jf)
    m32 = TRect(5, 3, 2.0, 1.0, device="cpu", dtype=torch.float32)
    f32 = TFunction(TSpace(m32, "DG", 1, dim=2))
    texp.HDF5Exporter(f32.function_space, str(tmp_path),
                      "Velocity2d").load(0, f32)
    assert f32.data.dtype == torch.float32
    assert np.array_equal(f32.data.numpy(), p.values.astype(np.float32))


def test_shape_mismatch_raises_in_both(tmp_path):
    p = Pair("p1dg", seed=4)
    texp.HDF5Exporter(p.tV, str(tmp_path), "Field").export_as_index(0, p.tf)
    other = Pair("cg1")
    with pytest.raises(ValueError, match="does not match"):
        texp.HDF5Exporter(other.tV, str(tmp_path), "Field").load(
            0, other.tf)
    with pytest.raises(ValueError, match="does not match"):
        jexp.HDF5Exporter(other.jV, str(tmp_path), "Field").load(
            0, other.jf)


def test_mesh_file_is_the_reference_s(tmp_path):
    p = Pair("p1dg", seed=5)
    texp.HDF5Exporter(p.tV, str(tmp_path / "t"), "F").export(p.tf)
    jexp.HDF5Exporter(p.jV, str(tmp_path / "j"), "F").export(p.jf)
    with h5py.File(tmp_path / "t" / "mesh.h5") as tf, \
            h5py.File(tmp_path / "j" / "mesh.h5") as jf:
        assert sorted(tf) == sorted(jf) == ["cells", "coords",
                                            "facet_marker"]
        for k in jf:
            assert tf[k].dtype == jf[k].dtype
            assert np.array_equal(tf[k][:], jf[k][:])


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_vtk_files_are_byte_equal(tmp_path, kind):
    p = Pair(kind, seed=6, name="uv_2d" if kind == "vector" else "elev_2d")
    te = texp.VTKExporter(p.tV, str(tmp_path / "t"), "Series")
    je = jexp.VTKExporter(p.jV, str(tmp_path / "j"), "Series")
    for i, t in enumerate((0.0, 12.5)):
        te.export(p.tf, time=t)
        je.export(p.jf, time=t)
    files = same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert files == [os.path.join("Series", f) for f in (
        "Series.pvd", "Series_00000.vtu", "Series_00001.vtu")]


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_npz_arrays_are_equal(tmp_path, kind):
    p = Pair(kind, seed=7)
    texp.NPZExporter(p.tV, str(tmp_path / "t"), "Series").export(
        p.tf, time=3.0)
    jexp.NPZExporter(p.jV, str(tmp_path / "j"), "Series").export(
        p.jf, time=3.0)
    for fn in ("Series_00000.npz", "Series_mesh.npz"):
        with np.load(tmp_path / "t" / fn) as a, \
                np.load(tmp_path / "j" / fn) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert np.array_equal(a[k], b[k], equal_nan=True)


@pytest.mark.parametrize("export_type", ["vtk", "npz", "hdf5"])
def test_export_manager_writes_the_reference_s_files(tmp_path, export_type):
    e, u = Pair("p1dg", seed=8), Pair("vector", seed=9, name="uv_2d")
    tfields, jfields = FieldDict(), jpkg.FieldDict()
    tfields.elev_2d, tfields.uv_2d = e.tf, u.tf
    jfields.elev_2d, jfields.uv_2d = e.jf, u.jf
    keys = ["elev_2d", "uv_2d", "salt_2d"]  # a missing key is skipped
    tm = texp.ExportManager(str(tmp_path / "t"), keys, tfields,
                            export_type=export_type)
    jm = jexp.ExportManager(str(tmp_path / "j"), keys, jfields,
                            export_type=export_type)
    for m in (tm, jm):
        m.set_next_export_ix(2)
        m.export(time=5.0, iteration=3)
    if export_type != "hdf5":
        same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
        return
    for fn in ("Elevation2d_00002.h5", "Velocity2d_00002.h5", "mesh.h5"):
        with h5py.File(tmp_path / "t" / "hdf5" / fn) as a, \
                h5py.File(tmp_path / "j" / "hdf5" / fn) as b:
            assert sorted(a) == sorted(b)
            assert all(a.attrs[k] == b.attrs[k] for k in b.attrs)
            for k in b:
                assert np.array_equal(a[k][:], b[k][:])


VOCAB = ["exp", "sqrt", "sin", "cos", "tan", "sinh", "cosh", "tanh", "ln",
         "abs"]


@pytest.mark.parametrize("name", VOCAB)
def test_facade_math_matches_the_reference(name):
    x = np.random.default_rng(10).uniform(0.1, 2.0, 17)
    got = getattr(tpkg, name)(x)
    assert isinstance(got, torch.Tensor) and got.dtype == F64
    ref = np.asarray(getattr(jpkg.api, name)(jnp.asarray(x)))
    assert np.allclose(got.numpy(), ref, rtol=1e-15, atol=0)
    t = torch.as_tensor(x)
    assert torch.equal(getattr(tpkg, name)(t), got)
    assert float(getattr(tpkg, name)(float(x[0]))) == pytest.approx(
        float(got[0]), rel=1e-15, abs=0)


def test_facade_expression_helpers_match_the_reference():
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((2, 9, 2))
    pairs = [
        (tpkg.conditional(a > b, a, b), jpkg.conditional(a > b, a, b)),
        (tpkg.min_value(a, 0.5), jpkg.min_value(a, 0.5)),
        (tpkg.max_value(a, b), jpkg.max_value(a, b)),
        (tpkg.dot(a, b), jpkg.dot(a, b)),
        (tpkg.as_vector([a[:, 0], 1.0]),
         jpkg.as_vector([jnp.asarray(a[:, 0]), 1.0])),
    ]
    for got, ref in pairs:
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert tpkg.pi == jpkg.pi


def test_facade_names_cover_the_reference_api():
    assert sorted(set(jpkg.__all__) ^ set(tpkg.__all__)) == []
    for name in tpkg.__all__:
        assert hasattr(tpkg, name), name
    V = tpkg.get_functionspace(
        tpkg.RectangleMesh(2, 2, 1.0, 1.0, device="cpu"), "DG", 1,
        vector=True)
    assert V.dim == 2 and V.family == "DG"
    W = tpkg.VectorFunctionSpace(V.mesh, "CG", 1)
    assert W.dof_shape() == (V.mesh.nv, 2)
    m = tpkg.Mesh2d(V.mesh.coords_np, V.mesh.cells_np, device="cpu")
    assert m.dtype == F64 and m.device.type == "cpu" and m.nc == V.mesh.nc
