"""Port parity: mesh tables, geometry, tabulations and every DGAssembler
operation of ``thetis_tpu_torch`` against ``thetis_tpu`` (f64, CPU).

Both packages build the same meshes from the same generator code and
take the same seeded numpy inputs.  Integer tables must be identical;
float results agree to roundoff (rtol 1e-12; the atol of 1e-12 x the
array's scale covers entries that cancel to ~0, where the two einsum
orders differ in the last bits)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.fem.assembly import (  # noqa: E402
    DGAssembler as JAsm, coefficient_cell_q as j_coeff)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS, Function as TFunction)
from thetis_tpu_torch.fem.assembly import (  # noqa: E402
    DGAssembler as TAsm, coefficient_cell_q as t_coeff)

F64 = torch.float64
MESHES = {
    "rect": (lambda g, **kw: g.RectangleMesh(6, 5, 1e4, 8e3, **kw)),
    "periodic": (lambda g, **kw: g.PeriodicRectangleMesh(
        6, 5, 1e4, 8e3, direction="x", **kw)),
}
INT_TABLES = ["cells", "facet_cells", "facet_variant", "facet_local",
              "cell_facets", "cell_sides", "facet_marker", "facet_verts",
              "facet_is_boundary"]
GEOMETRY = ["coords", "detJ", "Jinv", "cell_area", "facet_normal",
            "facet_len", "facet_l_normal", "cell_hmin"]


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


_CACHE = {}


def pair(kind):
    if kind not in _CACHE:
        jm = MESHES[kind](jgen)
        tm = MESHES[kind](tgen, device="cpu", dtype=F64)
        ja = JAsm(jm, JFS(jm, "DG", 1))
        ta = TAsm(tm, TFS(tm, "DG", 1))
        _CACHE[kind] = (jm, tm, ja, ta)
    return _CACHE[kind]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("name", INT_TABLES)
def test_connectivity_tables_identical(kind, name):
    jm, tm, _, _ = pair(kind)
    want = getattr(jm, name + "_np")
    np.testing.assert_array_equal(getattr(tm, name + "_np"), want)
    assert tm.nc == jm.nc and tm.nf == jm.nf and tm.nv == jm.nv
    assert tm.boundary_markers == jm.boundary_markers


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_device_tables_match_host(kind):
    _, tm, _, _ = pair(kind)
    for name in ("cells", "facet_cells", "facet_variant", "cell_facets",
                 "cell_sides", "facet_marker", "facet_verts"):
        t = getattr(tm, name)
        assert t.dtype == torch.int64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(tm, name + "_np"))
    np.testing.assert_array_equal(tm.facet_is_interior.numpy(),
                                  ~tm.facet_is_boundary_np)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_numpy_facet_fallback(kind, monkeypatch):
    """Without the C++ builder both packages take their numpy fallback,
    which numbers facets differently from the native builder but must
    agree between the packages and describe the same facet set."""
    _, tm, _, _ = pair(kind)
    monkeypatch.setenv("THETIS_TPU_NATIVE", "0")
    fj = MESHES[kind](jgen)
    ft = MESHES[kind](tgen, device="cpu", dtype=F64)
    for name in INT_TABLES:
        np.testing.assert_array_equal(getattr(ft, name + "_np"),
                                      getattr(fj, name + "_np"))
    assert ft.nf == tm.nf and ft.boundary_len == tm.boundary_len
    assert sorted(map(tuple, np.sort(ft.facet_verts_np, 1).tolist())) == \
        sorted(map(tuple, np.sort(tm.facet_verts_np, 1).tolist()))


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry(kind, name):
    jm, tm, _, _ = pair(kind)
    got = getattr(tm, name)
    assert got.dtype == F64
    close(got, getattr(jm, name))


def test_mesh_dtype_is_explicit():
    tm = tgen.RectangleMesh(3, 2, 1.0, 1.0, device="cpu",
                            dtype=torch.float32)
    V = TFS(tm, "DG", 1)
    asm = TAsm(tm, V)
    assert tm.detJ.dtype == torch.float32
    assert V.phi.dtype == torch.float32
    assert asm.both_gtabs_c.dtype == torch.float32
    assert asm.wdetJ.dtype == torch.float32


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("name", ["phi", "dphi", "qw", "qwf", "phi_f",
                                  "dphi_f", "qt"])
def test_tabulations(kind, name):
    _, _, ja, ta = pair(kind)
    close(ta.space.tab(name), ja.space.tab(name))


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("name", ["both_tabs", "both_gtabs_c", "wtabs_flat",
                                  "wgtabs_flat", "wdetJ", "wlen", "Mref",
                                  "Mref_inv", "cell_facet_flat"])
def test_assembler_tables(kind, name):
    _, _, ja, ta = pair(kind)
    close(getattr(ta, name), getattr(ja, name))


def _inputs(kind, rng):
    jm, _, _, _ = pair(kind)
    nc, nf = jm.nc, jm.nf
    nqf = 2
    return {
        "dofs_s": rng.standard_normal((nc, 3)),
        "dofs_v": rng.standard_normal((nc, 3, 2)),
        "cellq_s": rng.standard_normal((nc, 4)),
        "cellq_v": rng.standard_normal((nc, 4, 3)),
        "grad_v": rng.standard_normal((nc, 4, 3, 2)),
        "grad_s": rng.standard_normal((nc, 4, 2)),
        "facet_v": rng.standard_normal((nf, 2, nqf, 3)),
        "fgrad_v": rng.standard_normal((nf, 2, nqf, 2, 2)),
    }


OPS = {
    "cell_values_s": ("cell_values", ["dofs_s"]),
    "cell_values_v": ("cell_values", ["dofs_v"]),
    "cell_grads": ("cell_grads", ["dofs_v"]),
    "facet_traces": ("facet_traces", ["dofs_v"]),
    "facet_trace_grads": ("facet_trace_grads", ["dofs_v"]),
    "cell_to_dofs_s": ("cell_to_dofs", ["cellq_s"]),
    "cell_to_dofs_v": ("cell_to_dofs", ["cellq_v"]),
    "grad_to_dofs_s": ("grad_to_dofs", ["grad_s"]),
    "grad_to_dofs_v": ("grad_to_dofs", ["grad_v"]),
    "facet_to_dofs": ("facet_to_dofs", ["facet_v"]),
    "fgrad_to_dofs": ("fgrad_to_dofs", ["fgrad_v"]),
    "facet_fgrad_to_dofs": ("facet_fgrad_to_dofs", ["facet_v", "fgrad_v"]),
    "mass_apply_s": ("mass_apply", ["dofs_s"]),
    "mass_apply_v": ("mass_apply", ["dofs_v"]),
    "mass_inverse_v": ("mass_inverse", ["dofs_v"]),
}


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("op", sorted(OPS))
def test_assembler_ops(kind, op):
    _, _, ja, ta = pair(kind)
    meth, args = OPS[op]
    inp = _inputs(kind, np.random.default_rng(7))
    want = getattr(ja, meth)(*[jnp.asarray(inp[a]) for a in args])
    got = getattr(ta, meth)(*[torch.tensor(inp[a]) for a in args])
    close(got, want)


#: the rest of the assembler's public methods: name -> (method, input
#: shapes in (nc, nv) terms)
API_OPS = {"both_gtabs": ("both_gtabs", []),
           "facet_midpoint_data": ("facet_midpoint_data", [("nv",)]),
           "project_rhs_s": ("project_rhs", [("nc", 4)]),
           "project_rhs_v": ("project_rhs", [("nc", 4, 3)])}


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("op", sorted(API_OPS))
def test_assembler_api_methods(kind, op):
    jm, _, ja, ta = pair(kind)
    meth, shapes = API_OPS[op]
    rng = np.random.default_rng(11)
    inp = [rng.standard_normal([{"nc": jm.nc, "nv": jm.nv}.get(n, n)
                                for n in shape]) for shape in shapes]
    want = getattr(ja, meth)(*[jnp.asarray(a) for a in inp])
    close(getattr(ta, meth)(*[torch.tensor(a) for a in inp]), want)


#: evaluations a user's script hands host data (``asm.norm_l2(
#: np.asarray(...))``): the reference takes numpy arrays, so does the port
HOST_OPS = {"cell_values_s": ("cell_values", "dofs_s"),
            "cell_values_v": ("cell_values", "dofs_v"),
            "cell_grads": ("cell_grads", "dofs_v"),
            "integrate_s": ("integrate", "dofs_s"),
            "norm_l2_s": ("norm_l2", "dofs_s"),
            "norm_l2_v": ("norm_l2", "dofs_v")}


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("op", sorted(HOST_OPS))
def test_assembler_takes_numpy_input(kind, op):
    _, _, ja, ta = pair(kind)
    meth, arg = HOST_OPS[op]
    dofs = _inputs(kind, np.random.default_rng(5))[arg]
    got = getattr(ta, meth)(dofs)
    assert got.dtype == F64 and got.device.type == "cpu"
    close(got, getattr(ja, meth)(dofs))


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("coeff", ["scalar", "cg1", "dg", "p0", "cellq"])
def test_coefficient_cell_q(kind, coeff):
    jm, _, ja, ta = pair(kind)
    rng = np.random.default_rng(11)
    val = {"scalar": 2.5, "cg1": rng.standard_normal(jm.nv),
           "dg": rng.standard_normal((jm.nc, 3)),
           "p0": rng.standard_normal((jm.nc, 1)),
           "cellq": rng.standard_normal((jm.nc, 4))}[coeff]
    want = j_coeff(ja, val if np.isscalar(val) else jnp.asarray(val))
    got = t_coeff(ta, val if np.isscalar(val) else torch.tensor(val))
    close(got, want)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_interpolate_at_dof_coords(kind):
    from thetis_tpu.fem.functionspace import Function as JFunction

    jm, tm, ja, ta = pair(kind)

    def fj(x, y):
        return jnp.exp(-((x - 5e3) / 3e3) ** 2 - ((y - 4e3) / 3e3) ** 2)

    def ft(x, y):
        return torch.exp(-((x - 5e3) / 3e3) ** 2 - ((y - 4e3) / 3e3) ** 2)

    close(ta.space.dof_coords(), ja.space.dof_coords())
    close(TFunction(ta.space).interpolate(ft).data,
          JFunction(ja.space).interpolate(fj).data)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_interpolate_a_numpy_callable(kind):
    """A script's numpy callable (the tidal array's ``np.where`` sponge)
    is evaluated as numpy reads the reference's arrays, and its array
    lands on the mesh's device and dtype (on the card it gets host
    coordinates: ``chip_smoke.interpolate_checks``)."""
    from thetis_tpu.fem.functionspace import Function as JFunction

    _, _, ja, ta = pair(kind)

    def sponge(x, y):
        return np.where(x <= 2e3, 51.0 - x / 1e3, 1.0 + 0.0 * y)

    got = TFunction(ta.space).interpolate(sponge).data
    assert got.dtype == F64 and got.device == ta.mesh.device
    close(got, JFunction(ja.space).interpolate(sponge).data)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_interpolate_a_callable_of_device_tensors(kind):
    """A callable that closes over a tensor of the mesh's device gets
    the coordinates on that device, as the reference's callables get its
    device arrays."""
    from thetis_tpu.fem.functionspace import Function as JFunction

    _, _, ja, ta = pair(kind)
    h0 = TFunction(ta.space).assign(2.0).data
    seen = []

    def ft(x, y):
        seen.append(x.device)
        return h0 * torch.exp(-x / 1e4) + 0.0 * y

    def fj(x, y):
        return 2.0 * jnp.exp(-x / 1e4) + 0.0 * y

    got = TFunction(ta.space).interpolate(ft).data
    assert seen == [ta.mesh.device]
    close(got, JFunction(ja.space).interpolate(fj).data)
