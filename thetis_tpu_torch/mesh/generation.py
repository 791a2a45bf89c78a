"""Built-in mesh generators (port of ``thetis_tpu/mesh/generation.py``:
``RectangleMesh``, ``SquareMesh``, ``UnitSquareMesh`` and
``PeriodicRectangleMesh``), mirroring Firedrake's utility meshes.  The
host tables are built by the same numpy code as the reference, so both
packages produce identical connectivity.  Each constructor takes the
reference's arguments and, after them, ``device`` and ``dtype``: the card
and float64 unless asked otherwise (:func:`.mesh2d.default_device`).

Boundary marker convention matches Firedrake's RectangleMesh:
1: x = 0 (left), 2: x = Lx (right), 3: y = 0 (bottom), 4: y = Ly (top).
"""
import numpy as np
import torch

from .mesh2d import Mesh2d

__all__ = ["RectangleMesh", "SquareMesh", "UnitSquareMesh",
           "PeriodicRectangleMesh"]


def RectangleMesh(nx, ny, lx, ly, originX=0.0, originY=0.0,
                  name="rectangle", *, device=None, dtype=torch.float64):
    """Structured triangulated rectangle: nx*ny quads, each split into 2
    triangles (diagonal from lower-left to upper-right, like Firedrake's
    default 'crossed=False' left diagonal)."""
    x = np.linspace(originX, originX + lx, nx + 1)
    y = np.linspace(originY, originY + ly, ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = i.ravel()
    j = j.ravel()
    v00 = vid(i, j)
    v10 = vid(i + 1, j)
    v01 = vid(i, j + 1)
    v11 = vid(i + 1, j + 1)
    # split along the v00-v11 diagonal
    tri1 = np.stack([v00, v10, v11], axis=1)
    tri2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([tri1, tri2], axis=0)

    eps_x = lx * 1e-10 + 1e-300
    eps_y = ly * 1e-10 + 1e-300

    def markers(mid):
        m = np.zeros(len(mid), dtype=np.int32)
        m[np.abs(mid[:, 0] - originX) < eps_x] = 1
        m[np.abs(mid[:, 0] - (originX + lx)) < eps_x] = 2
        m[np.abs(mid[:, 1] - originY) < eps_y] = 3
        m[np.abs(mid[:, 1] - (originY + ly)) < eps_y] = 4
        return m

    return Mesh2d(coords, cells, boundary_markers=markers, name=name,
                  device=device, dtype=dtype)


def SquareMesh(nx, ny, l, name="square", *, device=None,
               dtype=torch.float64):
    return RectangleMesh(nx, ny, l, l, name=name, device=device,
                         dtype=dtype)


def UnitSquareMesh(nx, ny, name="unitsquare", *, device=None,
                   dtype=torch.float64):
    return RectangleMesh(nx, ny, 1.0, 1.0, name=name, device=device,
                         dtype=dtype)


def PeriodicRectangleMesh(nx, ny, lx, ly, direction="x",
                          name="periodic_rectangle", *, device=None,
                          dtype=torch.float64):
    """Rectangle periodic in x (``direction='x'``) or in both directions:
    the last column of vertices wraps to the first, so seam facets are
    ordinary interior facets; geometry uses seam-aware coordinate
    differences.  Boundary markers (x-periodic): 1 = y=0, 2 = y=ly."""
    # each refusal is the reference's AssertionError (its ``assert``s;
    # raised here so that ``python -O`` keeps them)
    if direction not in ("x", "both"):
        raise AssertionError("periodicity directions implemented: 'x', "
                             "'both'")
    # with nx < 3 two geometrically distinct edges share the same vertex
    # pair and the facet-by-vertex-pair representation degenerates
    if nx < 3:
        raise AssertionError("x-periodic meshes need nx >= 3")
    both = direction == "both"
    if both and ny < 3:
        raise AssertionError("y-periodic meshes need ny >= 3")
    x = np.arange(nx) * (lx / nx)
    nyv = ny if both else ny + 1
    y = (np.arange(ny) * (ly / ny) if both
         else np.linspace(0.0, ly, ny + 1))
    X, Y = np.meshgrid(x, y, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        jj = j % ny if both else j
        return (i % nx) * nyv + jj

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = i.ravel()
    j = j.ravel()
    v00 = vid(i, j)
    v10 = vid(i + 1, j)
    v01 = vid(i, j + 1)
    v11 = vid(i + 1, j + 1)
    tri1 = np.stack([v00, v10, v11], axis=1)
    tri2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([tri1, tri2], axis=0).astype(np.int32)

    if both:
        return Mesh2d(coords, cells, name=name, periodic_x_len=lx,
                      periodic_y_len=ly, device=device, dtype=dtype)

    eps_y = ly * 1e-10 + 1e-300

    def markers(mid):
        m = np.zeros(len(mid), dtype=np.int32)
        m[np.abs(mid[:, 1]) < eps_y] = 1
        m[np.abs(mid[:, 1] - ly) < eps_y] = 2
        return m

    return Mesh2d(coords, cells, boundary_markers=markers, name=name,
                  periodic_x_len=lx, device=device, dtype=dtype)
