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
import time

from ..config import BUILD_DIR

__all__ = ["load_library", "build_libraries", "CSRC_DIR"]

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


def _paths(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_libraries(names):
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is not
    built yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: seconds}`` for the sources compiled (0.0 for those
    already built); raises if any build fails."""
    t0 = time.perf_counter()
    procs = {}
    secs = {}
    for name in names:
        src, path = _paths(name)
        if os.path.exists(path):
            secs[name] = 0.0
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        # compiler output goes to a file: a full pipe would stall nvcc
        log = open(tmp + ".log", "w+")
        procs[name] = (src, path, tmp, cmd, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    failed = []
    pending = dict(procs)
    while pending:
        for name, (src, path, tmp, cmd, log, proc) in list(pending.items()):
            if proc.poll() is None:
                continue
            secs[name] = time.perf_counter() - t0
            del pending[name]
            log.seek(0)
            out = log.read()
            log.close()
            os.remove(tmp + ".log")
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src} ({proc.returncode}):"
                              f"\n{' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, path)
        time.sleep(0.02)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load_library(name):
    """Compile ``csrc/<name>.cu`` (once per source version) and return the
    loaded ``ctypes.CDLL``.  Raises if the build fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_libraries([name])
    lib = ctypes.CDLL(_paths(name)[1])
    _loaded[name] = lib
    return lib
