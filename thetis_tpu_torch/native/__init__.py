"""Native (C++) host mesh preprocessing, loaded via ctypes.

``meshbuild.cpp`` is a copy of ``thetis_tpu/native/meshbuild.cpp``.  It
is compiled at first use (``c++ -O3 -shared``) into the package's own
build directory ``thetis_tpu_torch/_build/`` (listed in ``.gitignore``);
every entry point has a pure-numpy fallback, so the package works
without a host toolchain.  This is host-side table construction, not a
device kernel.
"""
import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..config import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "meshbuild.cpp")
_lib = None
_tried = False


def _lib_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libmeshbuild-{digest}.so")


def _compile(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    for cc in ("c++", "g++", "cc"):
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            continue
        os.replace(tmp, path)
        return True
    return False


def get_meshbuild():
    """Return the loaded native library or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = _lib_path()
    if not os.path.exists(path) and not _compile(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.build_facets.restype = ctypes.c_int
    lib.build_facets.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p,
        i32p, i32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def build_facets_native(cells, nv):
    """Native facet-table construction; returns None if unavailable.

    :arg cells: (nc, 3) int32 CCW cell->vertex table
    :returns: dict of numpy arrays matching Mesh2d's internal tables
    """
    lib = get_meshbuild()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc = len(cells)
    maxf = 3 * nc
    cell_facets = np.empty((nc, 3), np.int32)
    cell_sides = np.empty((nc, 3), np.int32)
    facet_cells = np.empty((maxf, 2), np.int32)
    facet_local = np.empty((maxf, 2), np.int32)
    facet_verts = np.empty((maxf, 2), np.int32)
    facet_bnd = np.empty(maxf, np.int32)
    nf_out = ctypes.c_int64(0)
    ret = lib.build_facets(
        nc, int(nv), cells.reshape(-1),
        cell_facets.reshape(-1), cell_sides.reshape(-1),
        facet_cells.reshape(-1), facet_local.reshape(-1),
        facet_verts.reshape(-1), facet_bnd.reshape(-1),
        ctypes.byref(nf_out),
    )
    if ret != 0:
        return None
    nf = nf_out.value
    return dict(
        cell_facets=cell_facets,
        cell_sides=cell_sides,
        facet_cells=facet_cells[:nf].copy(),
        facet_local=facet_local[:nf].copy(),
        facet_verts=facet_verts[:nf].copy(),
        facet_is_boundary=facet_bnd[:nf].astype(bool),
    )
