"""Unstructured 2D meshes (``Mesh2d``, the rectangle generators) and the
sigma-layer ``ExtrudedMesh``."""
