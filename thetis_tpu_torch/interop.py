"""Carry states, fields and bathymetry between numpy and the port.

Both packages are fed from the same numpy data: the reference through
``jnp.asarray``, the port through these helpers; results come back as
numpy for comparison.
"""
import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy", "fields_from_numpy",
           "fields_to_numpy", "bathymetry_from_numpy", "bathymetry_to_numpy"]

_STATE_KEYS = ("elev", "uv")


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
