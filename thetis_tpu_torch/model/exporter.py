"""Field exporters and checkpoints (port of
``thetis_tpu/model/exporter.py``).

The HDF5 path writes each field's dof array with its mesh and time
metadata, one file per field and export index, and the mesh once per
directory in ``mesh.h5``: the reference's layout, so each package reads
the other's checkpoints.  It is the restart format of ``load_state``.
Visualization: a portable NPZ series or ParaView .vtu/.pvd files
(``VTKExporter``, written without external dependencies; the same bytes
as the reference's for the same values).

A field's tensor is copied to the host once per export
(``.detach().cpu().numpy()``); :meth:`HDF5Exporter.load` puts the stored
array on the field's device, in the field's dtype, and replaces
``field.data`` only.
"""
import os

import numpy as np
import torch

from .field_defs import field_metadata

__all__ = ["HDF5Exporter", "NPZExporter", "VTKExporter", "ExportManager",
           "solver_exporters", "load_checkpoint"]


def host(data):
    """A tensor (or array) as a host numpy array."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class HDF5Exporter:
    """One HDF5 file per field per export index, carrying function-space
    metadata; the mesh is stored once per output directory in ``mesh.h5``
    (ref ``exporter.py:19-97``)."""

    def __init__(self, space, outputdir, filename_prefix, verbose=False):
        self.space = space
        self.outputdir = outputdir
        self.filename = filename_prefix
        os.makedirs(outputdir, exist_ok=True)
        self.next_export_ix = 0
        self._mesh_written = False

    def gen_filename(self, iexport):
        return os.path.join(self.outputdir,
                            f"{self.filename}_{iexport:05d}.h5")

    def set_next_export_ix(self, ix):
        self.next_export_ix = ix

    def _ensure_mesh(self):
        """Write the mesh (coords, connectivity, facet markers) once per
        output directory, so a checkpoint set describes itself."""
        if self._mesh_written or self.space is None:
            return
        path = os.path.join(self.outputdir, "mesh.h5")
        self._mesh_written = True
        if os.path.exists(path):
            return
        import h5py

        mesh = self.space.mesh
        with h5py.File(path, "w") as f:
            f.create_dataset("coords", data=np.asarray(mesh.coords_np))
            f.create_dataset("cells", data=np.asarray(mesh.cells_np))
            if hasattr(mesh, "facet_marker_np"):
                f.create_dataset("facet_marker",
                                 data=np.asarray(mesh.facet_marker_np))

    def export_as_index(self, iexport, function, time=None, iteration=None):
        import h5py

        self._ensure_mesh()
        with h5py.File(self.gen_filename(iexport), "w") as f:
            f.create_dataset("data", data=host(function.data))
            f.attrs["name"] = function.name
            if self.space is not None:
                f.attrs["family"] = str(getattr(self.space, "family", ""))
                f.attrs["degree"] = int(getattr(self.space, "degree", -1))
            if time is not None:
                f.attrs["time"] = time
            if iteration is not None:
                f.attrs["iteration"] = int(iteration)
        self.next_export_ix = iexport + 1

    def export(self, function, time=None, iteration=None):
        self.export_as_index(self.next_export_ix, function, time=time,
                             iteration=iteration)

    def load(self, iexport, function):
        """Read export ``iexport`` into ``function.data`` (on its device,
        in its dtype); returns the stored time.  Raises ``ValueError`` on
        a shape mismatch (another mesh or space)."""
        import h5py

        with h5py.File(self.gen_filename(iexport), "r") as f:
            data = np.asarray(f["data"])
            time = f.attrs.get("time")
            it = f.attrs.get("iteration")
        old = function.data
        if data.shape != tuple(old.shape):
            raise ValueError(
                f"checkpoint {self.gen_filename(iexport)}: stored shape "
                f"{data.shape} does not match function {tuple(old.shape)}"
                " — wrong mesh or space")
        function.data = torch.as_tensor(data, dtype=old.dtype,
                                        device=old.device)
        self.last_iteration = None if it is None else int(it)
        return time


class NPZExporter:
    """Visualization series: the mesh once, then the nodal values per
    export (ref ``exporter.py:100-129``)."""

    def __init__(self, space, outputdir, filename_prefix, verbose=False):
        self.space = space
        self.outputdir = outputdir
        self.filename = filename_prefix
        os.makedirs(outputdir, exist_ok=True)
        self.next_export_ix = 0
        self._mesh_written = False

    def set_next_export_ix(self, ix):
        self.next_export_ix = ix

    def export(self, function, time=None):
        path = os.path.join(
            self.outputdir, f"{self.filename}_{self.next_export_ix:05d}.npz")
        # space is None for bare-array exports (optimisation callbacks)
        if self.space is not None and not self._mesh_written:
            mesh = self.space.mesh
            np.savez(os.path.join(self.outputdir,
                                  f"{self.filename}_mesh.npz"),
                     coords=mesh.coords_np, cells=mesh.cells_np)
            self._mesh_written = True
        np.savez(path, data=host(function.data),
                 time=np.asarray(time if time is not None else np.nan))
        self.next_export_ix += 1


class VTKExporter:
    """ParaView-compatible series (ref ``exporter.py:132-216``): ASCII
    XML .vtu files and a .pvd collection indexing them.

    P1DG fields are written as per-cell-vertex point data (3 points per
    triangle, discontinuous); CG1 fields on the shared mesh vertices;
    P2 CG fields by their vertex part."""

    def __init__(self, space, outputdir, filename_prefix, verbose=False):
        self.space = space
        self.outputdir = os.path.join(outputdir, filename_prefix)
        self.filename = filename_prefix
        os.makedirs(self.outputdir, exist_ok=True)
        self.next_export_ix = 0
        self._timesteps = []  # (time, relative path)

    def set_next_export_ix(self, ix):
        self.next_export_ix = ix

    def _write_vtu(self, path, points, cells, name, values):
        npts = len(points)
        ncl = len(cells)
        vals = np.asarray(values, dtype=np.float64)
        ncomp = 1 if vals.ndim == 1 else vals.shape[1]
        if ncomp == 2:  # pad 2D vectors to 3 components for ParaView
            vals = np.concatenate([vals, np.zeros((npts, 1))], axis=1)
            ncomp = 3
        pts3 = np.concatenate([points, np.zeros((npts, 1))], axis=1)
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                    'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
            f.write(f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncl}">\n')
            f.write('<Points><DataArray type="Float64" '
                    'NumberOfComponents="3" format="ascii">\n')
            np.savetxt(f, pts3, fmt="%.10g")
            f.write('</DataArray></Points>\n<Cells>\n')
            f.write('<DataArray type="Int32" Name="connectivity" '
                    'format="ascii">\n')
            np.savetxt(f, cells, fmt="%d")
            f.write('</DataArray>\n<DataArray type="Int32" Name="offsets" '
                    'format="ascii">\n')
            np.savetxt(f, 3 * np.arange(1, ncl + 1)[:, None], fmt="%d")
            f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
                    'format="ascii">\n')
            np.savetxt(f, np.full((ncl, 1), 5), fmt="%d")  # VTK_TRIANGLE
            f.write('</DataArray>\n</Cells>\n')
            f.write(f'<PointData Scalars="{name}">'
                    f'<DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            np.savetxt(f, vals.reshape(npts, -1), fmt="%.10g")
            f.write('</DataArray></PointData>\n')
            f.write('</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')

    def export(self, function, time=None):
        mesh = self.space.mesh
        data = host(function.data)
        coords = np.asarray(mesh.coords_np)
        cells = np.asarray(mesh.cells_np)
        if data.shape[:1] == (mesh.nv,):  # CG1 vertex data
            points, conn, vals = coords, cells, data
        elif data.shape[:2] == (mesh.nc, 3):  # P1DG: discontinuous points
            points = coords[cells].reshape(-1, 2)
            conn = np.arange(3 * mesh.nc).reshape(-1, 3)
            vals = data.reshape((3 * mesh.nc,) + data.shape[2:])
        else:  # e.g. P2 CG: the vertex part only
            points, conn = coords, cells
            vals = data[: mesh.nv]
        fname = f"{self.filename}_{self.next_export_ix:05d}.vtu"
        self._write_vtu(os.path.join(self.outputdir, fname),
                        points, conn, function.name or self.filename, vals)
        t = float(time) if time is not None else float(self.next_export_ix)
        self._timesteps.append((t, fname))
        self.next_export_ix += 1
        self._write_pvd()

    def _write_pvd(self):
        path = os.path.join(self.outputdir, f"{self.filename}.pvd")
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                    'version="0.1">\n<Collection>\n')
            for t, fn in self._timesteps:
                f.write(f'<DataSet timestep="{t}" file="{fn}"/>\n')
            f.write('</Collection>\n</VTKFile>\n')


class ExportManager:
    """The exporters of several fields (ref ``exporter.py:219-267``)."""

    def __init__(self, outputdir, fields_to_export, functions,
                 field_metadata=field_metadata, export_type="npz",
                 verbose=False):
        self.outputdir = outputdir
        self.fields_to_export = fields_to_export
        self.functions = functions
        self.exporters = {}
        for key in fields_to_export:
            fn = functions.get(key)
            if fn is None:
                continue
            meta = field_metadata.get(key, {"filename": key})
            if export_type == "hdf5":
                self.exporters[key] = HDF5Exporter(
                    fn.function_space, os.path.join(outputdir, "hdf5"),
                    meta["filename"])
            elif export_type == "vtk":
                self.exporters[key] = VTKExporter(
                    fn.function_space, outputdir, meta["filename"])
            else:
                self.exporters[key] = NPZExporter(
                    fn.function_space, outputdir, meta["filename"])

    def set_next_export_ix(self, ix):
        for e in self.exporters.values():
            e.set_next_export_ix(ix)

    def export(self, time=None, iteration=None):
        for key, e in self.exporters.items():
            if isinstance(e, HDF5Exporter):
                e.export(self.functions[key], time=time,
                         iteration=iteration)
            else:
                e.export(self.functions[key], time=time)

    def export_bathymetry(self, bathymetry_2d):
        """A one-off bathymetry file beside the field series
        (ref ``exporter.py:260-267``)."""
        meta = field_metadata.get("bathymetry_2d",
                                  {"filename": "bathymetry2d"})
        e = HDF5Exporter(bathymetry_2d.function_space,
                         os.path.join(self.outputdir, "hdf5"),
                         meta["filename"])
        e.export_as_index(0, bathymetry_2d)


def solver_exporters(options, fields, checkpoint_keys):
    """A solver's exporters (ref ``solver2d.py:704-730``,
    ``solver.py:1006-1073``): the visualization series of
    ``fields_to_export`` (VTK, or NPZ with ``export_format = 'npz'``) and
    the HDF5 checkpoints of ``fields_to_export_hdf5``, else of
    ``checkpoint_keys``; none under ``no_exports``."""
    if options.no_exports:
        return {}
    return {"vtk": ExportManager(options.output_directory,
                                 options.fields_to_export, fields,
                                 export_type=str(options.export_format)),
            "hdf5": ExportManager(options.output_directory,
                                  options.fields_to_export_hdf5
                                  or checkpoint_keys, fields,
                                  export_type="hdf5")}


def load_checkpoint(fields, keys, outputdir, i_export):
    """Read export ``i_export`` of each field in ``keys`` from
    ``outputdir/hdf5`` into ``fields`` (each on its device, in its
    dtype); returns the stored time (of the last field read)."""
    tload = None
    for key in keys:
        meta = field_metadata.get(key, {"filename": key})
        e = HDF5Exporter(fields[key].function_space, outputdir + "/hdf5",
                         meta["filename"])
        tload = e.load(i_export, fields[key])
    return tload
