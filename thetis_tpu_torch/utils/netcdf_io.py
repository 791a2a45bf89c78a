r"""netCDF reading layer (dependency-light).

The reference reads forcing files with the ``netCDF4`` package
(ref ``interpolation.py:243-306, 424-586``).  That package is not
available here, so this module provides a uniform read-only facade over

* :func:`scipy.io.netcdf_file` for classic NetCDF-3 files, and
* :mod:`h5py` for NetCDF-4 files (which are HDF5 containers),

plus the reference's CF-attribute variable lookup, time-axis parsing
(``NetCDFTimeParser``), file-tree time search (``NetCDFTimeSearch``) and
time-series interpolation (``NetCDFTimeSeriesInterpolator``).

Copied unchanged from ``thetis_tpu/utils/netcdf_io.py`` (numpy, scipy and
h5py only).
"""
import datetime
import re

import numpy as np

from .timezone import FixedTimeZone, datetime_to_epoch
from .interpolation import TimeSearch, LinearTimeInterpolator

__all__ = [
    "NCFile", "get_ncvar_name", "NetCDFTimeParser", "NetCDFTimeSearch",
    "NetCDFTimeSeriesReader", "NetCDFTimeSeriesInterpolator",
]


class _NCVar:
    """Uniform variable view: ``var[...]`` -> masked-value-filled ndarray,
    ``var.attrs`` -> dict of decoded attribute strings/values."""

    def __init__(self, name, data_fn, attrs, dimensions=()):
        self.name = name
        self._data_fn = data_fn
        self.attrs = attrs
        self.dimensions = tuple(dimensions)

    def __getitem__(self, idx):
        arr = np.asarray(self._data_fn()[idx])
        fill = self.attrs.get("_FillValue")
        if fill is not None and arr.dtype.kind == "f":
            arr = np.where(arr == np.asarray(fill, dtype=arr.dtype),
                           np.nan, arr)
        scale = self.attrs.get("scale_factor")
        off = self.attrs.get("add_offset")
        if scale is not None or off is not None:
            arr = arr * (1.0 if scale is None else float(np.asarray(scale))) \
                + (0.0 if off is None else float(np.asarray(off)))
        return arr

    @property
    def shape(self):
        return np.shape(self._data_fn())


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return b"".join(v.ravel()).decode("utf-8", "replace")
    return v


class NCFile:
    """Read-only netCDF file: NetCDF-3 via scipy, NetCDF-4 via h5py.

    Use as a context manager; ``.variables`` maps names to :class:`_NCVar`.
    """

    def __init__(self, filename):
        self.filename = filename
        with open(filename, "rb") as f:
            magic = f.read(8)
        self._h5 = None
        self._nc3 = None
        self.variables = {}
        if magic[:3] == b"CDF":
            from scipy.io import netcdf_file

            self._nc3 = netcdf_file(filename, "r", mmap=False)
            for name, var in self._nc3.variables.items():
                attrs = {k: _decode(v) for k, v in var._attributes.items()}
                self.variables[name] = _NCVar(
                    name, (lambda v=var: v.data), attrs, var.dimensions
                )
        elif magic[:8] == b"\x89HDF\r\n\x1a\n":
            import h5py

            self._h5 = h5py.File(filename, "r")

            def walk(group, prefix=""):
                for key, item in group.items():
                    if hasattr(item, "shape"):  # dataset
                        attrs = {k: _decode(item.attrs[k])
                                 for k in item.attrs}
                        dims = tuple(
                            d.label or "" for d in getattr(item, "dims", ())
                        )
                        self.variables[prefix + key] = _NCVar(
                            prefix + key, (lambda it=item: it), attrs, dims
                        )
                    else:
                        walk(item, prefix + key + "/")

            walk(self._h5)
        else:
            raise ValueError(f"{filename}: not a netCDF-3 or netCDF-4 file")

    def filepath(self):
        return self.filename

    def close(self):
        if self._nc3 is not None:
            self._nc3.close()
        if self._h5 is not None:
            self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_ncvar_name(ncfile, standard_name=None, long_name=None,
                   var_name=None):
    """Find a variable by CF ``standard_name``/``long_name`` attribute or
    plain variable name; standard_name takes precedence
    (ref ``interpolation.py:58-110``)."""
    assert standard_name is not None or long_name is not None or \
        var_name is not None

    def listify(arg):
        if arg is None:
            return []
        if not isinstance(arg, (list, tuple)):
            return [arg]
        return list(arg)

    standard_name = listify(standard_name)
    long_name = listify(long_name)
    var_name = listify(var_name)
    for name, var in ncfile.variables.items():
        sn = str(var.attrs.get("standard_name", "")).lower()
        ln = str(var.attrs.get("long_name", "")).lower()
        if sn and sn in standard_name:
            return name
        if ln and ln in long_name:
            return name
        if name.lower() in var_name:
            return name
    raise ValueError(
        f"Variable matching standard_name={standard_name} "
        f"long_name={long_name} var_name={var_name} not found in "
        f"{ncfile.filepath()}"
    )


_UNIT_SECONDS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0,
    "hour": 3600.0, "hours": 3600.0, "h": 3600.0, "hr": 3600.0,
    "day": 86400.0, "days": 86400.0, "d": 86400.0,
}

_SINCE_RE = re.compile(
    r"(?P<unit>\w+)\s+since\s+(?P<date>\d{1,4}-\d{1,2}-\d{1,2})"
    r"(?:[T ](?P<time>\d{1,2}:\d{2}(?::\d{2}(?:\.\d+)?)?))?"
    r"\s*(?P<tz>[+-]\d{1,2}:?\d{2}|Z|UTC)?"
)


def parse_time_units(units):
    """Parse a CF time-units string ('seconds since 1970-01-01 00:00:00')
    into (scale_seconds, epoch_offset_seconds)."""
    m = _SINCE_RE.match(units.strip())
    if m is None:
        raise ValueError(f"cannot parse time units: {units!r}")
    scale = _UNIT_SECONDS[m.group("unit").lower()]
    y, mo, d = (int(x) for x in m.group("date").split("-"))
    hh = mm = 0
    ss = 0.0
    if m.group("time"):
        parts = m.group("time").split(":")
        hh, mm = int(parts[0]), int(parts[1])
        if len(parts) > 2:
            ss = float(parts[2])
    tz = m.group("tz")
    if tz in (None, "Z", "UTC"):
        offset_h = 0.0
    else:
        sign = -1.0 if tz.startswith("-") else 1.0
        tz = tz.lstrip("+-").replace(":", "")
        offset_h = sign * (int(tz[:2]) + int(tz[2:] or 0) / 60.0)
    base = datetime.datetime(
        y, mo, d, hh, mm, int(ss),
        tzinfo=FixedTimeZone(offset_h, "tz"),
    )
    return scale, datetime_to_epoch(base) + (ss - int(ss))


class NetCDFTimeParser:
    """Time axis of one netCDF file as epoch seconds
    (ref ``interpolation.py:520-586``)."""

    def __init__(self, filename, time_variable_name="time",
                 allow_gaps=False, verbose=False):
        self.filename = filename
        self.time_variable_name = time_variable_name
        with NCFile(filename) as d:
            var = d.variables[time_variable_name]
            units = var.attrs.get("units")
            assert units is not None, f"Time units not defined: {filename}"
            scale, epoch0 = parse_time_units(str(units))
            raw = np.asarray(var[:], dtype=float).ravel()
            self.time_array = epoch0 + scale * raw
        self.start_time = self.time_array[0]
        self.end_time = self.time_array[-1]
        self.nb_steps = len(self.time_array)
        if self.nb_steps > 1:
            dt = np.diff(self.time_array)
            self.time_step = float(dt.mean())
            if not allow_gaps:
                assert np.allclose(dt, dt[0]), \
                    f"Time step is not constant: {filename}"
        else:
            self.time_step = 0.0

    def get_times(self):
        return self.time_array

    def find_time_stamp(self, t, previous=False):
        itime = int(np.searchsorted(self.time_array, t + 1e-6))
        if previous:
            itime -= 1
        if itime < 0 or itime >= len(self.time_array):
            raise IndexError(
                f"Requested time {t} out of bounds in {self.filename}"
            )
        return itime


class NetCDFTimeSearch(TimeSearch):
    """TimeSearch over a tree of netCDF files with CF time axes
    (ref ``interpolation.py:605-675``)."""

    def __init__(self, file_pattern, init_date=None,
                 time_variable_name="time", **kw):
        self.init_date = init_date
        offset = 0.0
        if init_date is not None:
            offset = datetime_to_epoch(init_date)
        self._offset = offset

        def times_fn(f):
            return NetCDFTimeParser(
                f, time_variable_name=time_variable_name, **kw
            ).get_times() - offset

        super().__init__(file_pattern, times_fn)

    def simulation_time_to_epoch(self, t):
        return t + self._offset


class NetCDFTimeSeriesReader:
    """Reader callable for LinearTimeInterpolator: extract the given
    variables' time slice (ref ``interpolation.py:259-306``)."""

    def __init__(self, variable_list, time_variable_name="time"):
        self.variable_list = list(variable_list)
        self.time_variable_name = time_variable_name

    def __call__(self, filename, time_index):
        with NCFile(filename) as d:
            out = []
            for name in self.variable_list:
                var = d.variables[name]
                if (var.dimensions and
                        var.dimensions[0] == self.time_variable_name) or \
                        len(var.shape) > 0:
                    out.append(np.asarray(var[time_index]))
                else:
                    out.append(np.asarray(var[:]))
        return out


class NetCDFTimeSeriesInterpolator:
    """Linear-in-time interpolation of netCDF scalar/array series over a
    file tree (ref ``interpolation.py:827-867``).

    :arg ncfile_pattern: glob pattern of input files
    :arg variable_list: variables to extract
    :arg init_date: datetime of simulation t=0 (times are returned
        relative to it)
    :kwarg scalars: multiplicative factor per variable
    :kwarg allow_gaps: tolerate non-uniform time steps
    """

    def __init__(self, ncfile_pattern, variable_list, init_date,
                 scalars=None, allow_gaps=False):
        self.variable_list = list(variable_list)
        self.scalars = scalars
        self.timesearch_obj = NetCDFTimeSearch(
            ncfile_pattern, init_date=init_date, allow_gaps=allow_gaps
        )
        reader = NetCDFTimeSeriesReader(variable_list)
        self.interpolator = LinearTimeInterpolator(
            self.timesearch_obj, reader
        )

    def __call__(self, t):
        vals = self.interpolator(t)
        vals = [np.asarray(v, dtype=float) for v in np.atleast_1d(vals)]
        if self.scalars is not None:
            vals = [v * s for v, s in zip(vals, self.scalars)]
        return vals if len(vals) > 1 else vals[0]
