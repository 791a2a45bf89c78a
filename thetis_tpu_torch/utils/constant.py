"""Mutable scalar/vector constants (port of ``thetis_tpu/utils/constant.py``).

Analogue of firedrake.Constant as used throughout the reference demos:
``update_forcings`` callbacks mutate Constants in place; the solver reads
their *values* every step, so a mutation takes effect at the next step.
The value is kept as float64 numpy on the host; :attr:`value` is a float64
CPU tensor, which the solver moves to its mesh's device and dtype.
"""
import numpy as np
import torch

__all__ = ["Constant"]


class Constant:
    def __init__(self, value, name=None):
        self._value = np.asarray(value, dtype=np.float64)
        self.name = name

    def assign(self, value):
        if isinstance(value, Constant):
            value = value._value
        self._value = np.broadcast_to(
            np.asarray(value, dtype=np.float64), self._value.shape
        ).copy()
        return self

    @property
    def value(self):
        return torch.as_tensor(self._value)

    @property
    def ndim(self):
        return self._value.ndim

    @property
    def shape(self):
        return self._value.shape

    def __float__(self):
        return float(self._value)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._value, dtype=dtype)

    # arithmetic on the current value
    def _v(self, o):
        return o._value if isinstance(o, Constant) else o

    def __add__(self, o):
        return self._value + self._v(o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._value - self._v(o)

    def __rsub__(self, o):
        return self._v(o) - self._value

    def __mul__(self, o):
        return self._value * self._v(o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._value / self._v(o)

    def __rtruediv__(self, o):
        return self._v(o) / self._value

    def __neg__(self):
        return -self._value

    def __pow__(self, o):
        return self._value ** self._v(o)

    def __getitem__(self, i):
        return self._value[i]

    def __repr__(self):
        return f"Constant({self._value})"
