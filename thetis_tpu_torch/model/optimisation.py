"""Optimisation-progress callbacks and user export managers (port of
``thetis_tpu/model/optimisation.py``).

The reference's ``thetis/optimisation.py`` (``optimisation.py:22-315``):
callbacks that plug into
:class:`~thetis_tpu_torch.adjoint.reduced_functional.ReducedFunctional`
hook points (``eval_cb_pre/post``, ``derivative_cb_pre/post``) to export
control/derivative fields and log functional values during an
optimisation run.  Control and derivative tensors are copied to the host
only where they are written (a Function keeps its device).

Callback argument convention (matching the reference): the current
control values are always the LAST positional argument; when more than
two arguments are given the first is the latest functional value.
"""
from abc import ABC, abstractmethod

import numpy as np

from ..fem.functionspace import Function
from ..utils.log import print_output
from .exporter import ExportManager, host
from .field_defs import field_metadata

__all__ = [
    "OptimisationCallback",
    "UserExportManager",
    "DeferredExportManager",
    "UserExportOptimisationCallback",
    "ControlsExportOptimisationCallback",
    "DerivativesExportOptimisationCallback",
    "OptimisationCallbackList",
    "FunctionalOptimisationCallback",
]


def _outputdir_of(solver_obj_or_outputdir):
    try:
        return solver_obj_or_outputdir.options.output_directory
    except AttributeError:
        return solver_obj_or_outputdir


class OptimisationCallback(ABC):
    """Base class for ReducedFunctional callbacks (ref optimisation.py:22)."""

    @abstractmethod
    def callback(self, *args):
        ...

    def __call__(self, *args):
        self.callback(*args)
        # derivative hooks must pass the derivatives/controls through
        return args[1] if len(args) > 1 else (args[0] if args else None)


class UserExportManager(ExportManager):
    """ExportManager for arbitrary user functions (ref optimisation.py:48).

    Functions whose name appears in ``field_metadata`` reuse the standard
    filename; unknown names use the function's own name, with an optional
    ``filename_prefix``."""

    def __init__(self, solver_obj_or_outputdir, functions_to_export,
                 filenames=None, filename_prefix="", shortnames=None,
                 **kwargs):
        outputdir = _outputdir_of(solver_obj_or_outputdir)
        names = shortnames or [f.name or f"field_{i}"
                               for i, f in enumerate(functions_to_export)]
        functions = dict(zip(names, functions_to_export))
        meta = {}
        for i, name in enumerate(names):
            base = field_metadata.get(name, {}).get("filename", name)
            fname = (filenames[i] if filenames is not None
                     else filename_prefix + base)
            meta[name] = {"filename": fname,
                          "shortname": field_metadata.get(name, {}).get(
                              "shortname", name)}
        super().__init__(outputdir, names, functions, field_metadata=meta,
                         **kwargs)


class DeferredExportManager:
    """A UserExportManager created lazily on the first export() call
    (ref optimisation.py:103): values passed to each export() are copied
    into a fixed set of Functions so subsequent calls may pass different
    arrays of the same shape."""

    def __init__(self, solver_obj_or_outputdir, **kwargs):
        self.target = solver_obj_or_outputdir
        self.kwargs = kwargs
        self.export_manager = None
        self.functions = None

    def export(self, values, suggested_names=None):
        if not isinstance(values, (list, tuple)):
            values = [values]
        if self.export_manager is None:
            self.functions = []
            for i, v in enumerate(values):
                space = getattr(v, "function_space", None)
                name = (suggested_names[i] if suggested_names
                        else getattr(v, "name", None) or f"control_{i}")
                if space is not None:
                    f = Function(space, name=name)
                else:
                    f = _ArrayHolder(v, name)
                self.functions.append(f)
            self.export_manager = UserExportManager(
                self.target, self.functions, **self.kwargs)
        for f, v in zip(self.functions, values):
            f.assign(getattr(v, "data", v))
        self.export_manager.export()


class _ArrayHolder:
    """Minimal Function-like wrapper for bare arrays or tensors (npz
    export only): holds a host copy."""

    def __init__(self, data, name):
        self.data = host(data)
        self.name = name
        self.function_space = None

    def assign(self, v):
        self.data = host(v)
        return self


class UserExportOptimisationCallback(UserExportManager, OptimisationCallback):
    """Exports a fixed list of model functions at every callback
    invocation (ref optimisation.py:145); args are ignored."""

    def __init__(self, solver_obj_or_outputdir, functions_to_export,
                 **kwargs):
        kwargs.setdefault("filename_prefix", "optimisation_")
        super().__init__(solver_obj_or_outputdir, functions_to_export,
                         **kwargs)

    def callback(self, *args):
        self.export()


class ControlsExportOptimisationCallback(DeferredExportManager,
                                         OptimisationCallback):
    """Exports the current control values (ref optimisation.py:172);
    controls are the last callback argument."""

    def __init__(self, solver_obj_or_outputdir, **kwargs):
        kwargs.setdefault("filename_prefix", "control_")
        super().__init__(solver_obj_or_outputdir, **kwargs)

    def callback(self, *args):
        self.export(list(args[-1]))


class DerivativesExportOptimisationCallback(DeferredExportManager,
                                            OptimisationCallback):
    """Exports adjoint derivatives; use as ``derivative_cb_post``
    (ref optimisation.py:188): args = (functional, derivatives, controls)."""

    def __init__(self, solver_obj_or_outputdir, **kwargs):
        kwargs.setdefault("filename_prefix", "derivative_")
        super().__init__(solver_obj_or_outputdir, **kwargs)

    def callback(self, *args):
        if len(args) != 3:
            raise TypeError(
                "DerivativesExportOptimisationCallback must be used as a "
                "derivative_cb_post callback (functional, derivatives, "
                "controls)")
        derivs = args[1]
        if not isinstance(derivs, (list, tuple)):
            derivs = [derivs]
        self.export(list(derivs))


class OptimisationCallbackList(list, OptimisationCallback):
    """A list of callbacks usable as one callback (ref optimisation.py:213)."""

    def callback(self, *args):
        for cb in self:
            cb(*args)


class FunctionalOptimisationCallback(OptimisationCallback):
    """Logs (and records) the functional value at each evaluation
    (ref optimisation.py:270)."""

    def __init__(self, name="functional"):
        self.name = name
        self.history = []

    def callback(self, *args):
        if not args:
            return
        value = args[0] if len(args) > 1 else args[0]
        if np.isscalar(value) or getattr(value, "ndim", 1) == 0:
            self.history.append(float(value))
            print_output(f"{self.name}: {float(value):.6e}")
