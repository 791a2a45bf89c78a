"""Carry states, fields and bathymetry between numpy and the port.

Both packages are fed from the same numpy data: the reference through
``jnp.asarray``, the port through these helpers; results come back as
numpy for comparison.
"""
import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy", "fields_from_numpy",
           "fields_to_numpy", "bathymetry_from_numpy", "bathymetry_to_numpy",
           "state3d_from_numpy", "state3d_to_numpy",
           "flowsolver3d_from_numpy"]

_STATE_KEYS = ("elev", "uv")
#: the 3D step's state dict (``FlowSolver._get_state``)
STATE3D_KEYS = ("elev", "psi_3d", "salt_3d", "split_residual", "temp_3d",
                "tke_3d", "uv", "uv_3d")


def _to_tensor(v, device, dtype):
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                           device=device)


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def state_from_numpy(d, device, dtype):
    """``{"uv": (nc,3,2), "elev": (nc,3)}`` numpy arrays -> tensors."""
    if sorted(d) != list(_STATE_KEYS):
        raise KeyError(f"swe state needs keys {_STATE_KEYS}, got {sorted(d)}")
    return {k: _to_tensor(v, device, dtype) for k, v in d.items()}


def state_to_numpy(s):
    return {k: _to_numpy(v) for k, v in s.items()}


def fields_from_numpy(d, device, dtype):
    """Coefficient fields (scalars or arrays) -> tensors (0-d for
    scalars)."""
    return {k: _to_tensor(v, device, dtype) for k, v in d.items()}


def fields_to_numpy(d):
    return {k: _to_numpy(v) for k, v in d.items()}


def bathymetry_from_numpy(b, device, dtype):
    """Bathymetry: a Python scalar stays a float (constant depth); an
    array (CG1 (nv,) or DG (nc, nd)) becomes a tensor."""
    if np.isscalar(b):
        return float(b)
    return _to_tensor(b, device, dtype)


def bathymetry_to_numpy(b):
    return float(b) if np.isscalar(b) else _to_numpy(b)


def state3d_from_numpy(d, device, dtype):
    """The 3D step state (``uv`` (nc,3,2), ``elev`` (nc,3), ``uv_3d``
    (nc,3,nz,2,2), ``salt_3d``/``temp_3d``/``tke_3d``/``psi_3d``
    (nc,3,nz,2), ``split_residual`` (nc,3,2)) as numpy arrays -> tensors."""
    if tuple(sorted(d)) != STATE3D_KEYS:
        raise KeyError(f"3D state needs keys {STATE3D_KEYS}, got "
                       f"{tuple(sorted(d))}")
    return {k: _to_tensor(v, device, dtype) for k, v in d.items()}


def state3d_to_numpy(s):
    return {k: _to_numpy(v) for k, v in s.items()}


def flowsolver3d_from_numpy(mesh2d, bathymetry, n_layers, options,
                            extrude_options=None):
    """The port's :class:`~thetis_tpu_torch.model.flowsolver3d.FlowSolver`
    from numpy inputs, on ``mesh2d``'s device and dtype: ``options`` is
    the dict given to ``options.update`` (array values, such as a CG1
    Coriolis field, become tensors), ``bathymetry`` a scalar or an array.
    The reference's solver is built from the same dict with its arrays
    passed through ``jnp.asarray``, so both compute the same step."""
    from .model.flowsolver3d import FlowSolver

    dev, dt = mesh2d.device, mesh2d.dtype
    opts = {k: (_to_tensor(v, dev, dt) if isinstance(v, np.ndarray) else v)
            for k, v in options.items()}
    return FlowSolver(mesh2d, bathymetry_from_numpy(bathymetry, dev, dt),
                      n_layers, options=opts,
                      extrude_options=extrude_options)
