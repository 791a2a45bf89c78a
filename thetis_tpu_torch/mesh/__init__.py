"""Unstructured 2D meshes: ``Mesh2d`` and the rectangle generators."""
