"""Extruded mesh and prism assembly port: ``ExtrudedMesh`` and every
``Assembler3D`` method of ``thetis_tpu_torch`` against ``thetis_tpu`` on
small meshes with a sloped bed, a non-zero free surface and stretched
sigma layers, fed the same numpy fields (f64, CPU).

Tolerance rtol 1e-12 (atol 1e-12 x the output's scale): the port
contracts the same tabulations with einsums where the reference unrolls
host-scalar multiply-adds, so only the summation order differs."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import (  # noqa: E402
    force_numpy, keep_state, pin_mesh_builders)

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402
import thetis_tpu.native as jnative  # noqa: E402
import thetis_tpu_torch.native as tnative  # noqa: E402

from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.mesh.extruded import ExtrudedMesh as JExt  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.assembly3d import Assembler3D as JA3  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh as TExt  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.assembly3d import Assembler3D as TA3  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
LX, LY, NZ = 1e3, 8e2, 3
SIGMA = np.array([0.0, 0.45, 0.8, 1.0])
MESHES = {
    "periodic": lambda g, **kw: g.PeriodicRectangleMesh(
        5, 4, LX, LY, direction="x", **kw),
    "rect": lambda g, **kw: g.RectangleMesh(4, 3, LX, LY, **kw),
}


class Case:
    def __init__(self, kind):
        jm = MESHES[kind](jgen)
        tm = MESHES[kind](tgen, device="cpu", dtype=F64)
        self.jm, self.tm = jm, tm
        self.ja = JA3(jm, JAsm(jm, JFS(jm, "DG", 1)), JExt(jm, NZ, SIGMA))
        self.ta = TA3(tm, TAsm(tm, TFS(tm, "DG", 1)), TExt(tm, NZ, SIGMA))
        xy = jm.coords_np
        # sloped bed, wavy free surface (CG1 per vertex -> cell nodes)
        bathy = 20.0 + 30.0 * xy[:, 1] / LY + 5.0 * np.sin(
            2 * np.pi * xy[:, 0] / LX)
        elev = 0.5 * np.cos(2 * np.pi * xy[:, 0] / LX) * (xy[:, 1] / LY)
        self.bathy = bathy[jm.cells_np]
        self.elev = elev[jm.cells_np]
        self.jz = self.ja.ext.z_interfaces(jnp.asarray(self.bathy),
                                           jnp.asarray(self.elev))
        self.tz = self.ta.ext.z_interfaces(torch.tensor(self.bathy),
                                           torch.tensor(self.elev))
        self.jg = self.ja.layer_geometry(self.jz)
        self.tg = self.ta.layer_geometry(self.tz)
        self.rng = np.random.default_rng(0)

    def rand(self, *shape):
        return self.rng.standard_normal(shape)


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request):
    return Case(request.param)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def both(case, name, *arrays, geom=False, **kw):
    """Call method ``name`` of both assemblers on the same numpy arrays."""
    ja = [jnp.asarray(a) for a in arrays]
    ta = [torch.tensor(a) for a in arrays]
    if geom:
        ja.append(case.jg)
        ta.append(case.tg)
    return (getattr(case.ta, name)(*ta, **kw),
            getattr(case.ja, name)(*ja, **kw))


def test_extruded_mesh_and_z_interfaces(case):
    np.testing.assert_array_equal(case.ta.ext.sigma_np, case.ja.ext.sigma_np)
    close(case.tz, case.jz)
    z = case.tz.numpy()
    assert (np.diff(z, axis=-1) > 0).all()  # layers keep positive thickness
    close(z[..., 0], -case.bathy)
    close(z[..., -1], case.elev)


def test_extruded_mesh_rejects_bad_sigma(case):
    with pytest.raises(ValueError):
        TExt(case.tm, NZ, np.linspace(0.1, 1.0, NZ + 1))
    with pytest.raises(ValueError):
        TExt(case.tm, NZ, np.linspace(0.0, 1.0, NZ))


@pytest.mark.parametrize("key", ["Delta_q", "dzdx_q", "Delta_nodes", "z_q",
                                 "gz_q", "z_if"])
def test_layer_geometry(case, key):
    close(case.tg[key], case.jg[key])


@pytest.mark.parametrize("k", [None, 2])
def test_cell_values(case, k):
    tail = () if k is None else (k,)
    close(*both(case, "cell_values", case.rand(case.jm.nc, 3, NZ, 2, *tail)))


@pytest.mark.parametrize("k", [None, 2])
def test_cell_grads(case, k):
    tail = () if k is None else (k,)
    close(*both(case, "cell_grads", case.rand(case.jm.nc, 3, NZ, 2, *tail),
                geom=True))


@pytest.mark.parametrize("k", [None, 2])
def test_interface_values(case, k):
    tail = () if k is None else (k,)
    (tb, ta), (jb, ja) = both(case, "interface_values",
                              case.rand(case.jm.nc, 3, NZ, 2, *tail))
    close(tb, jb)
    close(ta, ja)


@pytest.mark.parametrize("k", [None, 2])
def test_facet_traces(case, k):
    tail = () if k is None else (k,)
    close(*both(case, "facet_traces", case.rand(case.jm.nc, 3, NZ, 2, *tail)))


@pytest.mark.parametrize("k", [None, 2])
def test_facet_trace_grads_h(case, k):
    tail = () if k is None else (k,)
    close(*both(case, "facet_trace_grads_h",
                case.rand(case.jm.nc, 3, NZ, 2, *tail), geom=True))


def _nq(case):
    return case.ja.nq, case.ja.nqf, len(case.ja.qv_np)


@pytest.mark.parametrize("k", [None, 2])
def test_cell_to_dofs(case, k):
    nq, _, nqv = _nq(case)
    tail = () if k is None else (k,)
    close(*both(case, "cell_to_dofs",
                case.rand(case.jm.nc, NZ, nq, nqv, *tail), geom=True))


@pytest.mark.parametrize("k", [None, 2])
def test_grad_to_dofs(case, k):
    nq, _, nqv = _nq(case)
    tail = () if k is None else (k,)
    close(*both(case, "grad_to_dofs",
                case.rand(case.jm.nc, NZ, nq, nqv, *tail, 3), geom=True))


@pytest.mark.parametrize("k", [None, 2])
def test_vfacet_to_dofs(case, k):
    _, nqf, nqv = _nq(case)
    tail = () if k is None else (k,)
    close(*both(case, "vfacet_to_dofs",
                case.rand(case.jm.nf, 2, NZ, nqf, nqv, *tail), geom=True))


@pytest.mark.parametrize("k", [None, 2])
def test_vfacet_grad_to_dofs(case, k):
    _, nqf, nqv = _nq(case)
    tail = () if k is None else (k,)
    close(*both(case, "vfacet_grad_to_dofs",
                case.rand(case.jm.nf, 2, NZ, nqf, nqv, *tail, 2), geom=True))


@pytest.mark.parametrize("k", [None, 2])
def test_hfacet_to_dofs(case, k):
    nq, _, _ = _nq(case)
    tail = () if k is None else (k,)
    close(*both(case, "hfacet_to_dofs",
                case.rand(case.jm.nc, NZ + 1, nq, *tail),
                case.rand(case.jm.nc, NZ + 1, nq, *tail), geom=True))


@pytest.mark.parametrize("name", ["mass_apply", "mass_inverse"])
@pytest.mark.parametrize("k", [None, 2])
def test_mass(case, name, k):
    tail = () if k is None else (k,)
    close(*both(case, name, case.rand(case.jm.nc, 3, NZ, 2, *tail),
                geom=True))


def test_mass_matrices(case):
    """The dense 6x6 blocks, and their action equals ``mass_apply``'s."""
    got, want = both(case, "mass_matrices", geom=True)
    close(got, want)
    u = case.rand(case.jm.nc, 3, NZ, 2)
    Mu = torch.einsum("clij,clj->cli", got, torch.tensor(
        u.transpose(0, 2, 1, 3).reshape(case.jm.nc, NZ, 6)))
    close(Mu.reshape(case.jm.nc, NZ, 3, 2).permute(0, 2, 1, 3),
          case.ta.mass_apply(torch.tensor(u), case.tg).numpy())


def test_mass_inverse_inverts_mass_apply(case):
    u = torch.tensor(case.rand(case.jm.nc, 3, NZ, 2, 2))
    back = case.ta.mass_inverse(case.ta.mass_apply(u, case.tg), case.tg)
    close(back, u.numpy())


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("k", [None, 2])
def test_vertical_integral(case, average, k):
    tail = () if k is None else (k,)
    close(*both(case, "vertical_integral",
                case.rand(case.jm.nc, 3, NZ, 2, *tail), geom=True,
                average=average))


@pytest.mark.parametrize("from_top", [True, False])
def test_cumulative_integral(case, from_top):
    close(*both(case, "cumulative_integral",
                case.rand(case.jm.nc, 3, NZ, 2), geom=True,
                from_top=from_top))


#: the facet-indexed comparisons: (method, input shape after the tail-less
#: prefix, geometry argument)
FACET_CASES = {
    "facet_traces": (lambda c: (c.jm.nc, 3, NZ, 2), False),
    "facet_trace_grads_h": (lambda c: (c.jm.nc, 3, NZ, 2), True),
    "vfacet_to_dofs": (lambda c: (c.jm.nf, 2, NZ) + _nq(c)[1:], True),
    "vfacet_grad_to_dofs": (lambda c: (c.jm.nf, 2, NZ) + _nq(c)[1:], True),
}


@pytest.mark.parametrize("method", sorted(FACET_CASES))
@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_facet_cases_with_the_reference_on_numpy(kind, k, method,
                                                 monkeypatch):
    """The state in which these cases failed under several workers: the
    reference's builder latched onto its numpy fallback (a worker that
    loaded its half-written library) while the port's loads natively.
    The module's pin, made when it is imported, puts the port on its
    fallback too, and the facet-indexed arrays agree again."""
    for mod in (jnative, tnative):
        keep_state(monkeypatch, mod)
    force_numpy(monkeypatch, jnative)
    monkeypatch.setattr(tnative, "_tried", False)
    pin_mesh_builders()
    c = Case(kind)
    shape, geom = FACET_CASES[method]
    tail = () if k is None else (k,)
    extra = (2,) if method == "vfacet_grad_to_dofs" else ()
    close(*both(c, method, c.rand(*shape(c), *tail, *extra), geom=geom))
