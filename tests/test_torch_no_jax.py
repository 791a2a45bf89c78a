"""The port stands alone: importing ``thetis_tpu_torch`` and every one of
its submodules pulls in neither JAX, nor the JAX package, nor Triton
(whose kernels are built only inside the launching function), and no
source file of the port or of ``chip_smoke.py`` has an import statement
naming JAX or the JAX package."""
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
"""


def test_import_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert int(lines[0]) >= 15, out.stdout  # every submodule was imported
    bad = lines[1] if len(lines) > 1 else ""
    assert bad == "", f"port imported {bad}"


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|thetis_tpu)"
                     r"([.\s]|$)", re.M)


def test_no_import_statement_names_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, subdirs, fs in os.walk(PKG):
        subdirs[:] = [s for s in subdirs if s != "_build"]  # build output
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            for m in _IMPORT.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not hits, hits
