"""One facet builder for both packages.

Each package numbers a mesh's facets with its C++ builder (``native/``)
when the library loads, and with its numpy fallback otherwise; the two
number them differently.  The reference compiles its library in place
(``thetis_tpu/native/__init__.py``: ``-o libmeshbuild.so``, no temporary
file) and latches its first failure for the process, so under several
pytest workers on a tree without the library a worker can load a
half-written file and build every reference mesh with the fallback,
while the port (which writes its library to a temporary file and renames
it) stays native.  The parity tests compare facet-indexed arrays (facet
traces, CG2 and H(div) dofs) position by position, so there they failed
with O(1) differences.

:func:`pin_mesh_builders` gives both packages one builder for the
process: the native one when both load it, else both fallbacks.  Every
port test module that builds meshes of both packages calls it when it is
imported, before its first mesh.  The tests below put the two packages
in each combination of builder states, pin, and hold the tables equal.

The parity modules share one more helper from here:
:func:`strong_fields`, for a reference solver that steps more than
once (its jitted step is then compiled once, not twice)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import thetis_tpu.native as jnative  # noqa: E402
import thetis_tpu_torch.native as tnative  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402

TABLES = ["cell_facets", "cell_sides", "facet_cells", "facet_local",
          "facet_verts", "facet_is_boundary", "facet_marker"]


def pin_mesh_builders():
    """Both packages build facets with the same builder from now on in
    this process: native if both libraries load, else both on their numpy
    fallback (each package's own latch, ``_lib = None, _tried = True``)."""
    if jnative.get_meshbuild() is None or tnative.get_meshbuild() is None:
        for mod in (jnative, tnative):
            mod._lib, mod._tried = None, True


def strong_fields(solver):
    """Give a reference solver's weakly typed field arrays (a start made
    from a Python scalar) a strong dtype of their own, the same values.
    The reference's jitted step takes its state as arguments: a weakly
    typed start and the strongly typed state the first step returns are
    two signatures, so a run that calls the step again (``iterate()``
    over several exports, or step by step under ``update_forcings``)
    traces and compiles the whole step twice."""
    for f in solver.fields.values():
        data = getattr(f, "data", None)
        if getattr(data, "weak_type", False):
            f.data = jax.numpy.asarray(data, dtype=data.dtype)


def force_numpy(monkeypatch, mod):
    """A package's builder latched onto its fallback, as after a failed
    load of its library."""
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_tried", True)


def keep_state(monkeypatch, mod):
    """Restore a package's builder state after the test."""
    monkeypatch.setattr(mod, "_lib", mod._lib)
    monkeypatch.setattr(mod, "_tried", mod._tried)


@pytest.mark.parametrize("numpy_side", ["reference", "port", "both",
                                        "neither"])
@pytest.mark.parametrize("kind", ["rect", "periodic"])
def test_pinned_builders_number_facets_alike(kind, numpy_side, monkeypatch):
    """Whatever each package's builder state, after the pin both number
    a mesh's facets identically ("reference": the fault's state)."""
    for mod in (jnative, tnative):
        keep_state(monkeypatch, mod)
    if numpy_side in ("reference", "both"):
        force_numpy(monkeypatch, jnative)
    if numpy_side in ("port", "both"):
        force_numpy(monkeypatch, tnative)
    pin_mesh_builders()
    build = {"rect": lambda g, **kw: g.RectangleMesh(5, 3, 1e3, 8e2, **kw),
             "periodic": lambda g, **kw: g.PeriodicRectangleMesh(
                 5, 4, 1e3, 8e2, direction="x", **kw)}[kind]
    jm = build(jgen)
    tm = build(tgen, device="cpu", dtype=torch.float64)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tm, name + "_np"),
                                      getattr(jm, name + "_np"), name)
    if numpy_side == "neither" and jnative.get_meshbuild() is not None:
        assert tnative.get_meshbuild() is not None


def test_strong_fields_keep_values_and_drop_weak_types():
    """A weakly typed start is made strong, bit for bit; a strong one and
    a field without data are left as they are."""
    import jax.numpy as jnp
    from types import SimpleNamespace

    weak = jnp.full((4, 3), 10.0)
    strong = jnp.arange(3.0, dtype=weak.dtype)
    fields = {"temp_3d": SimpleNamespace(data=weak),
              "salt_3d": SimpleNamespace(data=strong),
              "bathymetry": SimpleNamespace()}
    assert weak.weak_type and not strong.weak_type
    strong_fields(SimpleNamespace(fields=fields))
    got = fields["temp_3d"].data
    assert not got.weak_type and got.dtype == weak.dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(weak))
    assert fields["salt_3d"].data is strong
    assert not hasattr(fields["bathymetry"], "data")
