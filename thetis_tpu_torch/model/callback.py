"""Diagnostic callback framework (port of the parts of
``thetis_tpu/model/callback.py`` that the 2D model runs).

Mirrors the reference's ``thetis/callback.py``: a ``CallbackManager`` with
'export'/'timestep' evaluation modes (ref L14-59), a ``DiagnosticCallback``
base (name, variable_names, ``__call__``, ``message_str``; ref L162-302)
and the volume conservation callback (ref L335-350).

Not ported yet: the HDF5 time series (``export_to_hdf5=True`` raises,
ROADMAP A10) and the tracer, overshoot, detector and time-series
callbacks (A8/A10).
"""
from collections import OrderedDict

from ..utils.log import print_output

__all__ = ["CallbackManager", "DiagnosticCallback",
           "ScalarConservationCallback", "VolumeConservation2DCallback"]


class CallbackManager(OrderedDict):
    """dict of dicts: mode -> {name: callback} (ref ``callback.py:14-59``)."""

    def add(self, callback, mode):
        key = callback.name
        self.setdefault(mode, OrderedDict())[key] = callback

    def evaluate(self, mode, index=None):
        for callback in self.get(mode, {}).values():
            callback.evaluate(index=index)


class DiagnosticCallback:
    """ABC (ref ``callback.py:162-302``)."""

    name = None
    variable_names = None

    def __init__(self, solver_obj, array_dim=1, append_to_log=True,
                 export_to_hdf5=False, start_time=None, end_time=None):
        if export_to_hdf5:
            raise NotImplementedError(
                "diagnostic HDF5 time series are not ported to "
                "thetis_tpu_torch yet (ROADMAP A10)")
        self.solver_obj = solver_obj
        self.append_to_log = append_to_log
        self.export_to_hdf5 = False
        self.start_time = start_time
        self.end_time = end_time
        self.array_dim = array_dim

    def set_write_mode(self, mode):
        pass

    def __call__(self):
        raise NotImplementedError

    def message_str(self, *args):
        return f"{self.name}: " + " ".join(str(a) for a in args)

    def push_to_log(self, time, args):
        if self.append_to_log:
            print_output(self.message_str(*args))

    def evaluate(self, index=None):
        t = self.solver_obj.simulation_time
        if self.start_time is not None and t < self.start_time:
            return
        if self.end_time is not None and t > self.end_time:
            return
        values = self.__call__()
        self.push_to_log(t, values)


class ScalarConservationCallback(DiagnosticCallback):
    """Tracks relative deviation of a scalar quantity
    (ref ``callback.py:305-332``)."""

    def __init__(self, scalar_callback, solver_obj, **kwargs):
        self.scalar_callback = scalar_callback
        self.initial_value = None
        super().__init__(solver_obj, **kwargs)

    def __call__(self):
        value = float(self.scalar_callback())
        if self.initial_value is None:
            self.initial_value = value
        rel_diff = ((value - self.initial_value)
                    / max(abs(self.initial_value), 1e-300))
        return value, rel_diff

    def message_str(self, *args):
        return f"{self.name} rel. error {args[1]:11.4e}"


class VolumeConservation2DCallback(ScalarConservationCallback):
    """integral of elevation (ref ``callback.py:335-350``)."""

    name = "volume2d"
    variable_names = ["integral", "relative_difference"]

    def __init__(self, solver_obj, **kwargs):
        def vol():
            return solver_obj.compute_volume_2d()

        super().__init__(vol, solver_obj, **kwargs)
