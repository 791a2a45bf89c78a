r"""Extruded 3D mesh: 2D triangles x vertical layers (sigma coordinates).

Port of ``thetis_tpu/mesh/extruded.py``.  Every 3D field is a dense
tensor over ``(cell, horizontal_node, layer, vertical_node)``, so vertical
operations are contiguous tensor ops and horizontal DG operations reuse
the 2D facet tables layer by layer.

z-coordinates are state: ``z_interfaces`` (nc, 3, nz+1) holds the
interface z at each horizontal P1 node, recomputed from (bathymetry,
elevation) at every ALE mesh update.
"""
import numpy as np
import torch

__all__ = ["ExtrudedMesh", "compute_z_interfaces"]


class ExtrudedMesh:
    """2D mesh x nz layers with sigma-distributed interfaces; tensors live
    on the 2D mesh's device and dtype."""

    def __init__(self, mesh2d, n_layers, sigma=None):
        """
        :arg mesh2d: Mesh2d
        :arg n_layers: number of vertical layers
        :arg sigma: optional (nz+1,) monotone array in [0, 1] (0 = bottom,
            1 = surface); default uniform
        """
        self.mesh2d = mesh2d
        self.nz = int(n_layers)
        if sigma is None:
            sigma = np.linspace(0.0, 1.0, self.nz + 1)
        sigma = np.asarray(sigma, dtype=np.float64)
        if sigma.shape != (self.nz + 1,):
            raise ValueError(f"sigma must be ({self.nz + 1},), got "
                             f"{sigma.shape}")
        if sigma[0] != 0.0 or sigma[-1] != 1.0:
            raise ValueError("sigma must run from 0 (bottom) to 1 (surface)")
        self.sigma_np = sigma
        self.sigma = torch.as_tensor(sigma, dtype=mesh2d.dtype,
                                     device=mesh2d.device)

    def z_interfaces(self, bathy_cell, elev_cell):
        """Interface z-coordinates (nc, 3, nz+1) for current (h, eta) given
        per-cell-node values (nc, 3): ``z = -h + sigma (h + eta)``."""
        return compute_z_interfaces(self.sigma, bathy_cell, elev_cell)

    def __repr__(self):
        return f"ExtrudedMesh({self.mesh2d.name} x {self.nz} layers)"


def compute_z_interfaces(sigma, bathy_cell, elev_cell):
    h = bathy_cell + elev_cell  # total depth at nodes (nc, 3)
    return -bathy_cell[..., None] + sigma[None, None, :] * h[..., None]
