"""Adjoint machinery: the pyadjoint-shaped API of
``thetis_tpu/adjoint/reduced_functional.py`` on ``torch.autograd``.

The forward model is an ordinary PyTorch function of the control tensors
(``FlowSolver2d.differentiable_forward``).  Its gradient is reverse-mode
autograd through the time loop; the implicit solves contribute their
implicit-function adjoints (the transposed Newton / ring / mass solves of
``solvers/``), never a taped Krylov iteration.  Values are computed under
``no_grad``; derivatives by :func:`torch.autograd.grad`.

API as the reference's (``ReducedFunctional(J_fn, controls)``,
``taylor_test``, ``minimize``), with the same callbacks.
"""
import numpy as np
import torch

__all__ = ["Control", "ReducedFunctional", "taylor_test", "minimize"]


def _data(v):
    """A Control, Function, Constant, tensor, array or scalar as a
    tensor (not copied when it is one)."""
    from ..fem.functionspace import Function
    from ..utils.constant import Constant

    if isinstance(v, Control):
        return v.value
    if isinstance(v, Function):
        return v.data
    if isinstance(v, Constant):
        return v.value
    return torch.as_tensor(v)


class Control:
    """Marks a tensor as an optimisation control (pyadjoint.Control
    analogue); holds the current value (a detached tensor on the value's
    own device and dtype)."""

    def __init__(self, value, name=None):
        self.value = _data(value).detach()
        self.name = name

    @property
    def shape(self):
        return self.value.shape


class ReducedFunctional:
    """J as a function of the controls, with gradients by reverse-mode
    autograd.

    :arg forward: callable ``forward(*control_tensors) -> scalar tensor``,
        the whole differentiable forward model and functional
    :arg controls: Control or list of Controls
    """

    def __init__(self, forward, controls, derivative_cb_post=None, scale=1.0,
                 eval_cb_pre=None, eval_cb_post=None, derivative_cb_pre=None):
        self.forward = forward
        self.controls = (
            list(controls) if isinstance(controls, (list, tuple)) else [controls]
        )
        self.scale = scale
        self.derivative_cb_post = derivative_cb_post
        self.derivative_cb_pre = derivative_cb_pre
        self.eval_cb_pre = eval_cb_pre
        self.eval_cb_post = eval_cb_post
        self._latest = tuple(c.value for c in self.controls)

    def _value_fn(self, *values):
        return self.scale * self.forward(*values)

    def _coerce(self, values):
        """Values as detached tensors on each control's device and dtype."""
        if values is None:
            return self._latest
        if not isinstance(values, (list, tuple)):
            values = [values]
        return tuple(
            torch.as_tensor(_data(v), dtype=c.value.dtype,
                            device=c.value.device).detach()
            for v, c in zip(values, self.controls))

    def _value_and_grads(self, values):
        values = tuple(v.clone().requires_grad_(True) for v in values)
        with torch.enable_grad():
            j = self._value_fn(*values)
        grads = torch.autograd.grad(j, values, allow_unused=True)
        grads = tuple(torch.zeros_like(v) if g is None else g
                      for g, v in zip(grads, values))
        return float(j.detach()), grads

    def __call__(self, values=None):
        values = self._coerce(values)
        self._latest = values
        if self.eval_cb_pre is not None:
            self.eval_cb_pre(values)
        with torch.no_grad():
            j = float(self._value_fn(*values))
        if self.eval_cb_post is not None:
            self.eval_cb_post(j, values)
        return j

    def derivative(self, values=None):
        values = self._coerce(values)
        if self.derivative_cb_pre is not None:
            self.derivative_cb_pre(values)
        j, grads = self._value_and_grads(values)
        if self.derivative_cb_post is not None:
            self.derivative_cb_post(j, grads, values)
        return grads if len(self.controls) > 1 else grads[0]

    def value_and_derivative(self, values=None):
        values = self._coerce(values)
        if self.eval_cb_pre is not None:
            self.eval_cb_pre(values)
        j, grads = self._value_and_grads(values)
        if self.eval_cb_post is not None:
            self.eval_cb_post(j, values)
        if self.derivative_cb_post is not None:
            self.derivative_cb_post(j, grads, values)
        return j, (grads if len(self.controls) > 1 else grads[0])


def taylor_test(rf, c, dc, n=4, h0=1e-2):
    """Second-order Taylor remainder convergence test
    (pyadjoint.taylor_test analogue; reference acceptance: rate > 1.9).

    Checks ``|J(c + h dc) - J(c) - h dJ.dc| = O(h^2)``; returns the
    minimum observed convergence rate."""
    ctl = rf.controls[0].value
    c = torch.as_tensor(_data(c), dtype=ctl.dtype, device=ctl.device)
    dc = torch.as_tensor(_data(dc), dtype=ctl.dtype, device=ctl.device)
    J0 = rf([c])
    g = rf.derivative([c])
    gdotdc = float((g * dc).sum())
    hs = [h0 / 2**i for i in range(n)]
    remainders = []
    for h in hs:
        Jh = rf([c + h * dc])
        remainders.append(abs(Jh - J0 - h * gdotdc))
    remainders = np.maximum(np.asarray(remainders), 1e-300)
    rates = np.log(remainders[:-1] / remainders[1:]) / np.log(2.0)
    print("taylor_test remainders:", remainders, "rates:", rates)
    return float(rates.min())


def minimize(rf, method="L-BFGS-B", bounds=None, options=None, callback=None):
    """Minimise a ReducedFunctional with scipy on float64 host vectors
    (the reference's pyadjoint.minimize path)."""
    from scipy import optimize as sciopt

    shapes = [tuple(c.shape) for c in rf.controls]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]

    def unpack(x):
        out = []
        ofs = 0
        for c, shp, sz in zip(rf.controls, shapes, sizes):
            out.append(torch.as_tensor(x[ofs:ofs + sz].reshape(shp),
                                       dtype=c.value.dtype,
                                       device=c.value.device))
            ofs += sz
        return out

    def fun(x):
        j, grads = rf.value_and_derivative(unpack(x))
        if len(rf.controls) == 1:
            grads = [grads]
        g = np.concatenate([gi.detach().to("cpu", torch.float64).numpy()
                            .ravel() for gi in grads])
        return j, g

    x0 = np.concatenate([c.value.detach().to("cpu", torch.float64).numpy()
                         .ravel() for c in rf.controls])
    if bounds is not None and not isinstance(bounds, sciopt.Bounds):
        # accepted forms: scipy-style [(lb, ub), ...] (one pair per
        # control entry; takes precedence in the ambiguous n == 2 case),
        # pyadjoint-style [lb_list, ub_list], or a single (lb, ub) pair
        # broadcast over all controls
        bounds = np.asarray(bounds, dtype=float)
        if bounds.ndim == 1 and len(bounds) == 2:
            bounds = [(bounds[0], bounds[1])] * len(x0)
        elif bounds.ndim == 2 and bounds.shape == (len(x0), 2):
            bounds = [tuple(b) for b in bounds]
        elif bounds.shape == (2, len(x0)):
            bounds = list(zip(bounds[0], bounds[1]))
    res = sciopt.minimize(
        fun, x0, jac=True, method=method, bounds=bounds,
        options=options or {}, callback=callback,
    )
    vals = unpack(res.x)
    return vals if len(rf.controls) > 1 else vals[0]
