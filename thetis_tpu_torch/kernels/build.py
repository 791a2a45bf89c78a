"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled with
``nvcc`` into a shared library that is loaded with ctypes (no PyTorch
headers, so a build takes seconds).  Libraries go to
``thetis_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, so an edited source is always rebuilt.
Nothing is built at import time: the first launch builds.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

from ..config import BUILD_DIR

__all__ = ["load_library", "CSRC_DIR"]

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_loaded = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use")


def load_library(name):
    """Compile ``csrc/<name>.cu`` (once per source version) and return the
    loaded ``ctypes.CDLL``.  Raises if the build fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    _loaded[name] = lib
    return lib
