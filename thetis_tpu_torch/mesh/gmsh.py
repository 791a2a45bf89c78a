"""Gmsh .msh reader, formats 2.2 ASCII and 4.1 ASCII (port of
``thetis_tpu/mesh/gmsh.py``).

Replaces firedrake's ``Mesh('file.msh')`` for the reference demos and
examples.  Line elements carry boundary markers (their physical tag);
triangles form the mesh (their physical tag becomes the cell region
marker ``cell_markers_np`` used for farm subdomains).  The mesh is a
:class:`~thetis_tpu_torch.mesh.mesh2d.Mesh2d` on ``device`` (default: the
card; without one, a mesh asked for with no ``device`` raises) in
``dtype``.
"""
import numpy as np
import torch

from .mesh2d import Mesh2d, default_device

__all__ = ["read_msh", "Mesh"]


def _read_msh_22(lines):
    it = iter(lines)
    nodes = {}
    tris = []
    tri_tags = []
    bnd_edges = []
    for line in it:
        if line.startswith("$Nodes"):
            n = int(next(it))
            for _ in range(n):
                parts = next(it).split()
                nodes[int(parts[0])] = (float(parts[1]), float(parts[2]))
        elif line.startswith("$Elements"):
            n = int(next(it))
            for _ in range(n):
                parts = next(it).split()
                etype = int(parts[1])
                ntags = int(parts[2])
                tags = [int(t) for t in parts[3:3 + ntags]]
                conn = [int(v) for v in parts[3 + ntags:]]
                phys = tags[0] if tags else 0
                if etype == 2:  # triangle
                    tris.append(conn)
                    tri_tags.append(phys)
                elif etype == 1:  # line
                    bnd_edges.append((conn[0], conn[1], phys))
    return nodes, tris, tri_tags, bnd_edges


def _read_msh_41(lines):
    it = iter(lines)
    nodes = {}
    tris = []
    tri_tags = []
    bnd_edges = []
    # entity -> physical tag maps
    ent_phys = {1: {}, 2: {}}
    for line in it:
        if line.startswith("$Entities"):
            counts = [int(x) for x in next(it).split()]
            npts, ncurves, nsurf = counts[0], counts[1], counts[2]
            for _ in range(npts):
                next(it)
            for _ in range(ncurves):
                parts = next(it).split()
                nphys = int(parts[7])
                ent_phys[1][int(parts[0])] = int(parts[8]) if nphys else 0
            for _ in range(nsurf):
                parts = next(it).split()
                nphys = int(parts[7])
                ent_phys[2][int(parts[0])] = int(parts[8]) if nphys else 0
        elif line.startswith("$Nodes"):
            nblocks = int(next(it).split()[0])
            for _ in range(nblocks):
                nn = int(next(it).split()[3])
                ids = [int(next(it)) for _ in range(nn)]
                for nid in ids:
                    parts = next(it).split()
                    nodes[nid] = (float(parts[0]), float(parts[1]))
        elif line.startswith("$Elements"):
            nblocks = int(next(it).split()[0])
            for _ in range(nblocks):
                dim, ent, etype, nn = (int(x) for x in next(it).split()[:4])
                phys = ent_phys.get(dim, {}).get(ent, 0)
                for _ in range(nn):
                    conn = [int(x) for x in next(it).split()][1:]
                    if etype == 2:
                        tris.append(conn)
                        tri_tags.append(phys)
                    elif etype == 1:
                        bnd_edges.append((conn[0], conn[1], phys))
    return nodes, tris, tri_tags, bnd_edges


def read_msh(path, name=None, *, device=None, dtype=torch.float64):
    """Read a gmsh .msh file into a :class:`Mesh2d` on ``device``."""
    device = default_device(device)
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    version = None
    for i, ln in enumerate(lines):
        if ln.startswith("$MeshFormat"):
            version = lines[i + 1].split()[0]
            break
    if version and version.startswith("2"):
        nodes, tris, tri_tags, bnd_edges = _read_msh_22(lines)
    else:
        nodes, tris, tri_tags, bnd_edges = _read_msh_41(lines)

    ids = sorted(nodes)
    remap = {nid: i for i, nid in enumerate(ids)}
    coords = np.array([nodes[nid] for nid in ids])
    cells = np.array([[remap[v] for v in t] for t in tris], dtype=np.int32)
    bm = np.array(
        [[remap[a], remap[b], tag] for (a, b, tag) in bnd_edges],
        dtype=np.int64,
    ) if bnd_edges else None
    mesh = Mesh2d(coords, cells, boundary_markers=bm,
                  name=name or str(path), device=device, dtype=dtype)
    mesh.cell_markers_np = np.asarray(tri_tags, dtype=np.int32)
    return mesh


def Mesh(path, name=None, *, device=None, dtype=torch.float64):
    """firedrake.Mesh lookalike for .msh files."""
    return read_msh(path, name=name, device=device, dtype=dtype)
