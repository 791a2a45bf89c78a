"""The port stands alone: importing ``thetis_tpu_torch`` and every one of
its submodules pulls in neither JAX, nor the JAX package, nor Triton
(whose kernels are built only inside the launching function), and no
source file of the port, of ``chip_smoke.py`` or of ``chip_ab.py`` has an
import statement naming JAX or the JAX package; neither does a demo or
example script as ``chip_smoke.py``'s runner rewrites it, and importing
``chip_smoke`` pulls in none of them."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "thetis_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
import thetis_tpu_torch
names = [m.name for m in pkgutil.walk_packages(thetis_tpu_torch.__path__,
                                                "thetis_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "thetis_tpu", "triton"))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

#: the 2D model's modules: the facade imports them with the package, and
#: the probe imports each by name as well
MODEL2D = ("model.flowsolver2d", "model.callback", "solvers.newton",
           "solvers.assembled", "solvers.fieldsplit", "solvers.schur",
           "timeintegration.steppers", "timeintegration.rungekutta",
           "timeintegration.implicitexplicit", "equations.tracer_2d",
           "equations.limiter", "equations.shallowwater_2d",
           "equations.swe_blocks", "mesh.generation", "utils.constant",
           "utils.log", "utils.profiling", "fem.functionspace", "interop",
           "model.sediment_model", "model.turbines", "equations.sediment_2d",
           "equations.exner", "equations.nh", "equations.shallowwater_dgcg",
           "equations.shallowwater_rtdg", "equations.shallowwater_rt2",
           "fem.rt", "fem.bdm", "fem.rt2", "fem.bdm2", "solvers.pcg",
           "mesh.sphere", "mesh.gmsh")
#: the 3D model's modules, the turbulence closure among them
MODEL3D = ("model.flowsolver3d", "equations.turbulence",
           "equations.stability_functions", "equations.momentum_3d",
           "equations.tracer_3d", "equations.utility3d", "equations.eos",
           "equations.limiter", "fem.assembly3d", "mesh.extruded",
           "kernels.tridiag", "kernels.ringmv")
#: I/O and forcing: the exporters, callbacks, optimisation callbacks,
#: diagnostics, file-driven forcing and the numpy utilities they copy
IO = ("model.exporter", "model.callback", "model.optimisation",
      "model.diagnostics", "model.forcing", "model.forcing_adapters",
      "utils.tides", "utils.netcdf_io", "utils.interpolation",
      "utils.timezone", "utils.coordsys")
#: the partitioned path: the partition tables, the halo refresh and the
#: reductions, the sharded equation, assembled CN and 3D step
PARALLEL = ("parallel", "parallel.partition", "parallel.submesh",
            "parallel.shard", "parallel.sharded", "parallel.assembled_sharded",
            "parallel.sharded3d")


def test_import_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert int(lines[0]) >= 70, out.stdout  # every submodule was imported
    bad = lines[1]
    assert bad == "", f"port imported {bad}"
    names = set(lines[2].split(","))
    missing = [m for m in MODEL2D + MODEL3D + IO + PARALLEL
               if f"thetis_tpu_torch.{m}" not in names]
    assert not missing, missing


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|thetis_tpu)"
                     r"([.\s]|$)", re.M)


def test_no_import_statement_names_jax():
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "chip_ab.py")]
    for d, subdirs, fs in os.walk(PKG):
        subdirs[:] = [s for s in subdirs if s != "_build"]  # build output
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            for m in _IMPORT.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not hits, hits


def _imported_modules(tree):
    """The modules a syntax tree imports: import statements and
    ``__import__("...")`` calls."""
    import ast

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_translated_scripts_import_no_jax():
    """Every ``.py`` of demos/ and examples/ (the helpers too), rewritten
    by ``chip_smoke.REWRITE_TABLE`` as the script runner runs it, imports
    neither JAX nor the JAX package, where every untranslated source
    imports one of them."""
    import ast
    import glob

    sys.path.insert(0, ROOT)
    import chip_smoke

    files = sorted(glob.glob(os.path.join(ROOT, "demos", "*.py"))
                   + glob.glob(os.path.join(ROOT, "examples", "**", "*.py"),
                               recursive=True))
    assert len(files) == 46
    before, hits = 0, []
    for path in files:
        with open(path) as f:
            src = f.read()
        for tree, out in ((ast.parse(src), None),
                          (ast.parse(chip_smoke.translate(src)), hits)):
            bad = [m for m in _imported_modules(tree)
                   if m.split(".")[0] in ("jax", "jaxlib", "thetis_tpu")]
            if out is None:
                before += bool(bad)
            else:
                out += [f"{os.path.relpath(path, ROOT)}: {m}" for m in bad]
    assert before == len(files)
    assert not hits, hits


def test_chip_smoke_pulls_in_no_jax():
    """Importing ``chip_smoke`` (the script runner among it) imports
    neither JAX, nor the JAX package, nor Triton."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    probe = ("import sys, chip_smoke; print(','.join(sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
             "'thetis_tpu', 'triton'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
