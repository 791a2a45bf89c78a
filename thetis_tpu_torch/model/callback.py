"""Diagnostic callback framework (port of
``thetis_tpu/model/callback.py``).

Mirrors the reference's ``thetis/callback.py``: a ``CallbackManager`` with
'export'/'timestep' evaluation modes, appendable HDF5 time series
(``DiagnosticHDF5``), a ``DiagnosticCallback`` base (name,
variable_names, ``__call__``, ``message_str``), the conservation and
overshoot monitors, the detector and station callbacks, the accumulator
and the vertical profile and transect callbacks.

A callback reads its values on the host, once per evaluation.  Point
location runs once, in host numpy, when a callback is built; sampling
gathers the few cells it needs on the fields' device and copies them to
the host in one transfer per evaluation (the reference copies the whole
field per detector and field).  The host then does the reference's numpy
arithmetic on the same values, so the numbers are the reference's.
"""
import os
from collections import OrderedDict

import numpy as np
import torch

from ..utils.log import print_output

__all__ = ["CallbackManager", "DiagnosticCallback", "DiagnosticHDF5",
           "ScalarConservationCallback", "VolumeConservation2DCallback",
           "VolumeConservation3DCallback",
           "TracerMassConservation3DCallback",
           "TracerMassConservation2DCallback", "MinMaxConservationCallback",
           "TracerOvershootCallBack", "DetectorsCallback",
           "TimeSeriesCallback2D", "AccumulatorCallback",
           "VerticalProfileCallback", "TimeSeriesCallback3D",
           "TransectCallback"]


class CallbackManager(OrderedDict):
    """dict of dicts: mode -> {name: callback} (ref ``callback.py:14-59``)."""

    def add(self, callback, mode):
        key = callback.name
        self.setdefault(mode, OrderedDict())[key] = callback

    def evaluate(self, mode, index=None):
        for callback in self.get(mode, {}).values():
            callback.evaluate(index=index)


class DiagnosticHDF5:
    """Appendable HDF5 time series (ref ``callback.py:62-159``)."""

    def __init__(self, filename, varnames, array_dim=1, attrs=None):
        import h5py

        self.filename = filename
        self.varnames = varnames
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with h5py.File(filename, "w") as f:
            f.create_dataset("time", (0, 1), maxshape=(None, 1))
            for v in varnames:
                f.create_dataset(v, (0, array_dim),
                                 maxshape=(None, array_dim))
            for k, val in (attrs or {}).items():
                f.attrs[k] = val

    def export(self, time, variables):
        import h5py

        with h5py.File(self.filename, "a") as f:
            ix = f["time"].shape[0]
            f["time"].resize((ix + 1, 1))
            f["time"][ix] = time
            for name, val in zip(self.varnames, variables):
                ds = f[name]
                ds.resize((ix + 1, ds.shape[1]))
                ds[ix, :] = np.atleast_1d(np.asarray(val))


class DiagnosticCallback:
    """ABC (ref ``callback.py:162-302``)."""

    name = None
    variable_names = None

    def __init__(self, solver_obj, array_dim=1, append_to_log=True,
                 export_to_hdf5=False, start_time=None, end_time=None):
        self.solver_obj = solver_obj
        self.append_to_log = append_to_log
        self.export_to_hdf5 = export_to_hdf5
        self.start_time = start_time
        self.end_time = end_time
        self._hdf5 = None
        self.array_dim = array_dim

    def set_write_mode(self, mode):
        pass

    def _create_hdf5(self):
        fn = os.path.join(
            self.solver_obj.options.output_directory,
            "diagnostic_" + self.name.replace(" ", "_") + ".hdf5")
        self._hdf5 = DiagnosticHDF5(fn, self.variable_names, self.array_dim)

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
        if self.export_to_hdf5:
            if self._hdf5 is None:
                self._create_hdf5()
            self._hdf5.export(t, values)


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


def _gather_host(picks):
    """``[(tensor, index), ...]`` -> the host arrays ``tensor[index]``,
    gathered on the tensors' device and copied in one transfer."""
    parts = [t[torch.as_tensor(ix, device=t.device)] for t, ix in picks]
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out, k = [], 0
    for p in parts:
        out.append(flat[k:k + p.numel()].reshape(tuple(p.shape)))
        k += p.numel()
    return out


def locate_points(mesh, pts):
    """Owner cell and barycentric weights of each point (host numpy, once;
    thetis_tpu L250-279): the first cell that contains the point,
    else the cell of the nearest centroid."""
    coords = mesh.coords_np
    cells = mesh.cells_np
    p0, p1, p2 = (coords[cells[:, i]] for i in range(3))
    cell_ids = np.zeros(len(pts), dtype=np.int32)
    bary = np.zeros((len(pts), 3))
    for i, p in enumerate(pts):
        v0 = p1 - p0
        v1 = p2 - p0
        v2 = p[None, :] - p0
        d00 = (v0 * v0).sum(1)
        d01 = (v0 * v1).sum(1)
        d11 = (v1 * v1).sum(1)
        d20 = (v2 * v0).sum(1)
        d21 = (v2 * v1).sum(1)
        denom = d00 * d11 - d01 * d01
        v = (d11 * d20 - d01 * d21) / denom
        w = (d00 * d21 - d01 * d20) / denom
        u = 1.0 - v - w
        inside = (u >= -1e-10) & (v >= -1e-10) & (w >= -1e-10)
        cand = np.nonzero(inside)[0]
        if len(cand) == 0:
            mids = coords[cells].mean(axis=1)
            cand = [np.argmin(((mids - p) ** 2).sum(1))]
        c = int(cand[0])
        cell_ids[i] = c
        bary[i] = [u[c], v[c], w[c]]
    return cell_ids, bary


class DetectorsCallback(DiagnosticCallback):
    """Point samples of fields at detector locations (thetis_tpu
    L230-298): barycentric interpolation in the owner cell (the
    reference's stand-in for a VertexOnlyMesh)."""

    def __init__(self, solver_obj, detector_locations, field_names, name,
                 detector_names=None, **kwargs):
        self.name = name
        self.field_names = field_names
        self.detector_names = detector_names or [
            f"detector{i}" for i in range(len(detector_locations))]
        self.variable_names = self.detector_names
        ncomp = sum(2 if f.startswith("uv") else 1 for f in field_names)
        super().__init__(solver_obj, array_dim=ncomp, **kwargs)
        self.cell_ids, self.bary = locate_points(
            solver_obj.mesh2d, np.asarray(detector_locations, dtype=float))

    def _samples(self):
        """Each field at every detector, (np,) or (np, k) host arrays."""
        fields = self.solver_obj.fields
        picks = [(fields[f].data, self.cell_ids) for f in self.field_names]
        out = []
        for cd in _gather_host(picks):  # (np, 3[, k])
            if cd.ndim == 3:
                out.append(np.einsum("pd,pdk->pk", self.bary, cd))
            else:
                out.append(np.einsum("pd,pd->p", self.bary, cd))
        return out

    def __call__(self):
        samples = self._samples()
        out = []
        for i in range(len(self.cell_ids)):
            vals = [np.atleast_1d(np.atleast_2d(v)[i] if np.ndim(v) > 1
                                  else v[i:i + 1]) for v in samples]
            out.append(np.concatenate(vals))
        return out

    def message_str(self, *args):
        return f"{self.name}: sampled {len(args)} detectors"


class TimeSeriesCallback2D(DetectorsCallback):
    """Station time series (thetis_tpu L301-309)."""

    def __init__(self, solver_obj, fieldnames, x, y, location_name, **kwargs):
        super().__init__(
            solver_obj, [[x, y]], fieldnames,
            name=f"timeseries_{location_name}",
            detector_names=[location_name], **kwargs)


class AccumulatorCallback(DiagnosticCallback):
    """Time integral of a scalar spatial functional (trapezium rule),
    e.g. a time-dependent objective functional (thetis_tpu L312-341)."""

    variable_names = ["spatial integral at current timestep"]

    def __init__(self, scalar_callback, solver_obj, name="accumulator",
                 **kwargs):
        kwargs.setdefault("export_to_hdf5", False)
        kwargs.setdefault("append_to_log", False)
        self.name = name
        super().__init__(solver_obj, **kwargs)
        self.scalar_callback = scalar_callback
        self.dt = float(solver_obj.options.timestep)
        self.integrant = 0.0
        self.old_value = None

    def __call__(self):
        value = float(self.scalar_callback())
        if self.old_value is not None:
            self.integrant += 0.5 * (self.old_value + value) * self.dt
        self.old_value = value
        return [value]

    def get_val(self):
        return self.integrant

    def message_str(self, *args):
        return f"{self.name} value {args[0]:11.4e}"


class _ColumnSampler(DiagnosticCallback):
    """The 3D callbacks' common part: the owner columns of horizontal
    points, and per evaluation the interface profiles of 3D fields there
    with the interface z coordinates (thetis_tpu L344-363)."""

    def _locate_columns(self, pts):
        self.cells, self.barys = locate_points(self.solver_obj.mesh2d, pts)

    def _profiles(self, fieldnames):
        """z (npts, nz+1) and, per field, (npts, nz+1[, k]) profiles."""
        s = self.solver_obj
        picks = [(s.fields[f].data, self.cells) for f in fieldnames]
        ix = torch.as_tensor(self.cells, device=s.bathy_cell.device)
        z_cells = s.extruded.z_interfaces(s.bathy_cell[ix],
                                          s.fields.elev_2d.data[ix])
        host_vals = _gather_host(
            picks + [(z_cells, np.arange(len(self.cells)))])
        z_if = host_vals[-1]                        # (npts, 3, nz+1)
        zs = np.stack([np.einsum("d,dz->z", b, z)
                       for b, z in zip(self.barys, z_if)])
        profs = []
        for d in host_vals[:-1]:                    # (npts, 3, nz, 2[, k])
            prof_bot = d[:, :, :, 0]
            prof_top = d[:, :, :, 1]
            interior = 0.5 * (prof_top[:, :, :-1] + prof_bot[:, :, 1:])
            prof = np.concatenate([prof_bot[:, :, :1], interior,
                                   prof_top[:, :, -1:]], axis=2)
            prof = np.stack([np.einsum("d,dz...->z...", b, p)
                             for b, p in zip(self.barys, prof)])
            if prof.ndim > 2:  # vector: magnitude (the reference's choice)
                prof = np.linalg.norm(prof, axis=-1)
            profs.append(prof)
        return zs, profs


class VerticalProfileCallback(_ColumnSampler):
    """Vertical profiles of 3D fields at an (x, y) location (thetis_tpu
    L366-406): values at the layer interfaces of the column that holds
    the point, after the interface z coordinates."""

    def __init__(self, solver_obj, fieldnames, x, y, location_name,
                 **kwargs):
        self.fieldnames = list(fieldnames)
        self.location_name = location_name
        short = "-".join(f.split("_")[0] for f in self.fieldnames)
        self.name = f"vertprofile_{location_name}_{short}"
        self.variable_names = ["z_coord"] + list(self.fieldnames)
        super().__init__(solver_obj, array_dim=solver_obj.n_layers + 1,
                         **kwargs)
        self._locate_columns(np.asarray([[x, y]], dtype=float))

    def __call__(self):
        z, profs = self._profiles(self.fieldnames)
        return [z[0]] + [p[0] for p in profs]

    def message_str(self, *args):
        return (f"{self.name}: profile range "
                + " ".join(f"{v.min():.3g}..{v.max():.3g}"
                           for v in args[1:]))


class TimeSeriesCallback3D(_ColumnSampler):
    """Station time series of 3D fields at an (x, y, z) point
    (thetis_tpu L409-446): the column's profile interpolated to z,
    clamped into the instantaneous water column."""

    def __init__(self, solver_obj, fieldnames, x, y, z, location_name,
                 **kwargs):
        self.fieldnames = list(fieldnames)
        self.location_name = location_name
        self.z = float(z)
        short = "-".join(f.split("_")[0] for f in self.fieldnames)
        self.name = f"timeseries_{location_name}_{short}"
        self.variable_names = list(self.fieldnames)
        super().__init__(solver_obj, array_dim=1, **kwargs)
        self._locate_columns(np.asarray([[x, y]], dtype=float))

    def __call__(self):
        z, profs = self._profiles(self.fieldnames)
        z_if = z[0]
        z_pt = np.clip(self.z, z_if.min(), z_if.max())
        return [np.atleast_1d(np.interp(z_pt, z_if, p[0])) for p in profs]

    def message_str(self, *args):
        return (f"{self.name}: "
                + " ".join(f"{float(np.ravel(v)[0]):.4g}" for v in args))


class TransectCallback(_ColumnSampler):
    """Fields on a vertical transect along a horizontal polyline
    (thetis_tpu L449-491): one flattened (n_points * (nz+1)) array per
    field, after the z coordinates."""

    def __init__(self, solver_obj, fieldnames, x, y, location_name,
                 n_points=None, **kwargs):
        self.fieldnames = list(fieldnames)
        x = np.atleast_1d(np.asarray(x, dtype=float))
        y = np.atleast_1d(np.asarray(y, dtype=float))
        if x.shape != y.shape:
            raise ValueError(f"x {x.shape} and y {y.shape} differ in shape")
        pts = np.stack([x, y], axis=-1)
        short = "-".join(f.split("_")[0] for f in self.fieldnames)
        self.name = f"transect_{location_name}_{short}"
        self.variable_names = ["z_coord"] + list(self.fieldnames)
        super().__init__(solver_obj,
                         array_dim=len(pts) * (solver_obj.n_layers + 1),
                         **kwargs)
        self._locate_columns(pts)

    def __call__(self):
        z, profs = self._profiles(self.fieldnames)
        return [z.reshape(-1)] + [p.reshape(-1) for p in profs]

    def message_str(self, *args):
        return (f"{self.name}: transect range "
                + " ".join(f"{v.min():.3g}..{v.max():.3g}"
                           for v in args[1:]))
