"""Diagnostic callback framework (port of the parts of
``thetis_tpu/model/callback.py`` that the 2D and 3D models run).

Mirrors the reference's ``thetis/callback.py``: a ``CallbackManager`` with
'export'/'timestep' evaluation modes (ref L14-59), a ``DiagnosticCallback``
base (name, variable_names, ``__call__``, ``message_str``; ref L162-302),
the 2D and 3D volume conservation callbacks (ref L335-364), the 3D and 2D
tracer mass callbacks (ref L367-409) and the overshoot callbacks (ref
L434-484).
A callback reads its values on the host, once per evaluation.

Not ported yet: the HDF5 time series (``export_to_hdf5=True`` raises,
ROADMAP A10) and the detector and time-series callbacks (A10).
"""
from collections import OrderedDict

from ..utils.log import print_output

__all__ = ["CallbackManager", "DiagnosticCallback",
           "ScalarConservationCallback", "VolumeConservation2DCallback",
           "VolumeConservation3DCallback",
           "TracerMassConservation3DCallback",
           "TracerMassConservation2DCallback", "MinMaxConservationCallback",
           "TracerOvershootCallBack"]


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


class VolumeConservation3DCallback(ScalarConservationCallback):
    """total 3D water volume (ref ``callback.py:353-364``)."""

    name = "volume3d"
    variable_names = ["integral", "relative_difference"]

    def __init__(self, solver_obj, **kwargs):
        def vol():
            return solver_obj.compute_volume_3d()

        super().__init__(vol, solver_obj, **kwargs)


class TracerMassConservation3DCallback(ScalarConservationCallback):
    """3D tracer mass (ref ``callback.py:367-382``)."""

    def __init__(self, tracer_name, solver_obj, **kwargs):
        self.name = tracer_name + " mass"
        self.variable_names = ["integral", "relative_difference"]

        def mass():
            return solver_obj.compute_tracer_mass_3d(tracer_name)

        super().__init__(mass, solver_obj, **kwargs)


class TracerMassConservation2DCallback(ScalarConservationCallback):
    """depth-integrated tracer mass (ref ``callback.py:385-409``)."""

    def __init__(self, tracer_name, solver_obj, **kwargs):
        self.name = tracer_name + " mass"
        self.variable_names = ["integral", "relative_difference"]

        def mass():
            return solver_obj.compute_tracer_mass(tracer_name)

        super().__init__(mass, solver_obj, **kwargs)


class MinMaxConservationCallback(DiagnosticCallback):
    """overshoot tracking (ref ``callback.py:434-463``)."""

    variable_names = ["min_value", "max_value", "undershoot", "overshoot"]

    def __init__(self, minmax_callback, solver_obj, **kwargs):
        self.minmax_callback = minmax_callback
        self.initial_value = None
        super().__init__(solver_obj, array_dim=1, **kwargs)

    def __call__(self):
        value = self.minmax_callback()
        if self.initial_value is None:
            self.initial_value = value
        overshoot = max(value[1] - self.initial_value[1], 0.0)
        undershoot = min(value[0] - self.initial_value[0], 0.0)
        return value[0], value[1], undershoot, overshoot

    def message_str(self, *args):
        return f"{self.name} overshoots {args[2]:g} {args[3]:g}"


class TracerOvershootCallBack(MinMaxConservationCallback):
    """tracer overshoot (ref ``callback.py:466-484``)."""

    def __init__(self, tracer_name, solver_obj, **kwargs):
        self.name = tracer_name + " overshoot"

        def minmax():
            d = solver_obj.fields[tracer_name].data
            return float(d.min()), float(d.max())

        super().__init__(minmax, solver_obj, **kwargs)
