"""The repo's demos (``demos/*.py``) through the port, from their own
source, on the CPU in f64: each through ``chip_smoke.run_script`` (the
script copied with demos/ and examples/ and rewritten by
``chip_smoke.REWRITE_TABLE``, nothing else), its own checks and those of
``tests/test_demos.py`` where it has them; ``demo_3d_channel.py`` also
through ``thetis_tpu`` (as ``tests/test_demos.py`` runs it: CPU, x64),
every field of its solver held to the port's.

This file also holds what the example files share: the coverage of every
script by name (:func:`covered`), the reference's run of a script
(:func:`run_reference`) and the field comparison
(:func:`assert_fields_match`).

Tolerance: rtol 1e-9 of each field's scale (:func:`scales`: its largest
value; the solver's largest velocity for each velocity; at least the
water depth for the elevation), f64: the two packages sum in other
orders, and the implicit solves stop at their own tolerances in both.
The example files name the scripts held to another, with the reason."""
import contextlib
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import (  # noqa: E402
    pin_mesh_builders, strong_fields)

pin_mesh_builders()

import chip_smoke  # noqa: E402
from thetis_tpu import config as jconfig  # noqa: E402
from thetis_tpu.model.flowsolver2d import (  # noqa: E402
    FlowSolver2d as JFlowSolver2d)
from thetis_tpu.model.flowsolver3d import (  # noqa: E402
    FlowSolver as JFlowSolver)
from thetis_tpu_torch import config as tconfig  # noqa: E402

F64 = torch.float64
RTOL = 1e-9
#: the demos of this file; ``slow`` where the port's run takes over ~30 s
#: on one CPU thread
SCRIPTS = {"demos/demo_2d_channel.py": (), "demos/demo_2d_channel_bnd.py": (),
           "demos/demo_2d_multiple_tracers.py": (),
           "demos/demo_2d_north_sea.py": (), "demos/demo_2d_tracer.py": (),
           "demos/demo_3d_channel.py": ()}
#: scripts held to the reference in tier-1 here; the others are in ``slow``
PARITY = ("demos/demo_3d_channel.py",)


def script_params(scripts, parity=None):
    """pytest parameters of ``scripts`` (name -> marks), by path; with
    ``parity``, the scripts not in it under ``slow``."""
    return [pytest.param(p, marks=(marks if parity is None or p in parity
                                   else (pytest.mark.slow,)), id=p)
            for p, marks in sorted(scripts.items())]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def keep_constants(monkeypatch):
    """A script may set ``physical_constants`` (the tidal array's rho0):
    both packages' copies are put back after each test."""
    for mod in (jconfig, tconfig):
        for k, v in mod.physical_constants.items():
            monkeypatch.setitem(mod.physical_constants, k, v)


def run_port(script, namespace=None, solvers=None):
    """The script through the port on the CPU in f64: its namespace and
    solvers (``chip_smoke.run_script``)."""
    return chip_smoke.run_script(script, "cpu", F64, namespace=namespace,
                                 solvers=solvers)


@contextlib.contextmanager
def strong_starts(classes):
    """While the block runs, each solver of ``classes`` gives its fields
    strong dtypes (:func:`test_torch_mesh_builders.strong_fields`, the
    same values) when its ``iterate()`` starts: a script's weakly typed
    start would compile the reference's jitted step twice."""
    iterates = [(c, c.iterate) for c in classes]
    for c, iterate in iterates:
        def strong_iterate(self, *a, _iterate=iterate, **k):
            strong_fields(self)
            return _iterate(self, *a, **k)

        c.iterate = functools.wraps(iterate)(strong_iterate)
    try:
        yield
    finally:
        for c, iterate in iterates:
            c.iterate = iterate


def run_reference(script, tmp_path, namespace=None, solvers=None):
    """The script through ``thetis_tpu`` on the CPU (x64, as
    ``tests/test_examples.py`` runs it), from a copy of demos/ and
    examples/ as they are, in the script's directory: its namespace and
    the solvers it made."""
    tree = str(tmp_path / "reference")
    chip_smoke.copy_scripts(tree, rewrite=None)
    full = os.path.join(tree, script)
    solvers = [] if solvers is None else solvers
    with (chip_smoke.script_process_state(full),
          chip_smoke.solvers_made((JFlowSolver2d, JFlowSolver), solvers),
          strong_starts((JFlowSolver2d, JFlowSolver))):
        ns = chip_smoke.exec_script(full, namespace)
    return SimpleNamespace(namespace=ns, solvers=solvers)


def fields(solver):
    """A solver's fields (either package) as host arrays, by name."""
    out = {}
    for k, f in solver.fields.items():
        data = getattr(f, "data", None)
        if isinstance(data, torch.Tensor):
            out[k] = data.detach().cpu().numpy()
        elif data is not None and hasattr(data, "shape"):
            out[k] = np.asarray(data)
    return out


#: a solver's velocities, held to one scale: where the flow has no
#: vertical structure the 3D deviation velocity and the vertical velocity
#: are roundoff of the depth average (the barotropic wave's uv_3d: 3e-15
#: beside 0.44 m/s), with no scale of their own
VELOCITIES = ("uv_2d", "uv_3d", "w_3d")


def scales(solver, arrays):
    """Each field's scale: its largest value; the velocities' the largest
    of them; the elevation's at least the water depth (an unforced
    basin's elevation is roundoff of the water column: 1e-9 m in the
    Ekman cases)."""
    out = {k: float(np.abs(v).max()) for k, v in arrays.items()}
    vel = max([out[k] for k in VELOCITIES if k in out], default=0.0)
    out.update({k: vel for k in VELOCITIES if k in out})
    if "elev_2d" in out:
        bathy = getattr(solver, "bathy_cell", None)
        if bathy is None:
            bathy = solver.bathymetry_dof
        if isinstance(bathy, torch.Tensor):
            bathy = bathy.detach().cpu().numpy()
        out["elev_2d"] = max(out["elev_2d"], float(np.abs(bathy).max()))
    return out


def assert_fields_match(port, reference, rtol=RTOL):
    """The solvers of a script's two runs, one for one: the same steps,
    every field of each, the same names, to ``rtol`` of its scale
    (:func:`scales`)."""
    assert len(port) == len(reference) > 0
    for p, r in zip(port, reference):
        got, want = fields(p), fields(r)
        assert sorted(got) == sorted(want)
        assert p.iteration == r.iteration
        scale = scales(r, want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            err = float(np.abs(got[k] - w).max()) / max(scale[k], 1e-300)
            assert err <= rtol, (k, err)


def assert_finite(solvers):
    for s in solvers:
        for k, v in fields(s).items():
            assert np.isfinite(v).all(), k


@pytest.mark.parametrize("script", script_params(SCRIPTS))
def test_demo_runs_through_the_port(script):
    run = run_port(script)
    assert_finite(run.solvers)
    ns, so = run.namespace, run.namespace["solver_obj"]
    # tests/test_demos.py's checks
    if script == "demos/demo_2d_tracer.py":
        q = fields(so)["tracer_2d"]
        assert 0.5 < q.min() and q.max() < 2.5
        assert ns["rel_err"] < 0.5
    elif script == "demos/demo_2d_channel_bnd.py":
        assert float(so.asm.norm_l2(so.fields.uv_2d.data)) > 1.0
    elif script == "demos/demo_3d_channel.py":
        assert abs(fields(so)["salt_3d"] - 4.5).max() < 1e-8
        assert float(so.asm.norm_l2(so.fields.uv_2d.data)) > 1.0


@pytest.mark.parametrize("script", script_params(SCRIPTS, PARITY))
def test_demo_matches_the_reference(script, tmp_path):
    ref = run_reference(script, tmp_path).solvers
    assert_fields_match(run_port(script).solvers, ref)


#: the rewrite table's rows 2-6 on the forms the scripts use: each
#: snippet's ``r`` through JAX as written and through the port as
#: rewritten (``chip_smoke.translate``)
SNIPPETS = {
    "jnp_functions": (
        "import jax.numpy as jnp\n"
        "x = jnp.stack([jnp.asarray([0.5, 1.5]), jnp.full((2,), 3.0)], "
        "axis=-1)\n"
        "r = jnp.sin(jnp.pi * x) + jnp.cos(x) * jnp.sqrt(x) - jnp.log(x) "
        "+ jnp.exp(-x) + jnp.arctan(x) + jnp.abs(-x) "
        "+ jnp.broadcast_to(jnp.asarray(2.0), (2, 2)) "
        "+ jnp.full_like(x, 1.5) + jnp.zeros((2, 2))"),
    "where_einsum_astype": (
        "import jax.numpy as jnp\n"
        "x = jnp.asarray([0.5, 1.5, 2.5])\n"
        "m = jnp.stack([(x > 1.0).astype(x.dtype), (x < 2.0).astype("
        "x.dtype)])\n"
        "r = jnp.einsum('k,kv->v', jnp.asarray([2.0, 3.0]), m) "
        "+ jnp.where(x > 1.0, x, 0.0)"),
    "at_set": (
        "import numpy as np\nimport jax.numpy as jnp\n"
        "idx = jnp.asarray(np.nonzero(np.array([0, 1, 0, 1, 0]))[0])\n"
        "r = jnp.zeros((5,)).at[idx].set(jnp.asarray([2.0, 4.0]))"),
    "jit_and_import": (
        "import jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "f = jax.jit(lambda v: 2.0 * v)\n"
        "r = f(__import__('jax.numpy', fromlist=['asarray']).asarray("
        "[1.0, 2.0]))"),
    "numpy_reads": (
        "import numpy as np\nimport jax.numpy as jnp\n"
        "x = jnp.asarray([1.0, 4.0])\n"
        "r = np.asarray(x - np.array([0.5, 0.5])) * np.asarray(x)"),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_rewrite_table(name):
    src = SNIPPETS[name]
    want = {}
    exec(compile(src, name, "exec"), want)
    got = {}
    with (chip_smoke.jax_shims("cpu", F64),
          chip_smoke.numpy_reads_tensors()):
        exec(compile(chip_smoke.translate(src), name, "exec"), got)
    r = got["r"]
    r = r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
    assert r.dtype == np.float64
    np.testing.assert_allclose(r, np.asarray(want["r"]), rtol=1e-15,
                               atol=1e-15)


def covered():
    """Every script of demos/ and examples/ by the test file that runs
    it."""
    import test_torch_examples_2d as e2
    import test_torch_examples_3d as e3

    return {"demos": sorted(SCRIPTS), "examples_2d": sorted(e2.SCRIPTS),
            "examples_3d": sorted(e3.SCRIPTS),
            "examples_inversion": sorted(e2.INVERSION_SCRIPTS)}


def test_every_script_is_covered():
    """The scripts named in the three files are the glob of demos/*.py and
    examples/**/*.py less the helper modules, each once."""
    named = [p for group in covered().values() for p in group]
    assert len(named) == len(set(named))
    assert sorted(named) == chip_smoke.example_scripts()
    assert len(named) == 42
