r"""Serial equations run over a halo partition (port of
``thetis_tpu/parallel/sharded.py``).

The mechanism (the PyOP2-halo analogue, SURVEY.md sections 2.10 / 5.8):

1. :class:`~thetis_tpu_torch.parallel.submesh.HaloPartition` builds one
   SubMesh per partition, on the partition's device; the caller builds the
   ordinary serial assembler and equation on each (``build_eq``).
2. Each residual / mass evaluation refreshes every partition's ghost rows
   (:func:`~.shard.halo_extend`), runs that partition's *unchanged serial*
   ``residual`` on its extended rows, and keeps its owned rows.

:class:`ShardedEquation` has the standard equation interface
(``residual`` / ``mass_term`` / ``mass_inverse``) over striped-global
tensors, so every serial time integrator (``timeintegration.steppers``)
runs partitioned without modification.

The reference traces one template equation inside ``shard_map`` and
rebinds it to per-device tables stacked over a device axis
(``harvest_graph`` / ``clone_graph`` / ``_clone_with_tables``); one
process drives R real instances here, one a partition, so nothing is
rebound.
"""
import numpy as np
import torch

from .shard import halo_extend

__all__ = ["ShardedEquation"]


class ShardedEquation:
    """Partitioned adapter around serial equation instances.

    :arg partition: a :class:`~.submesh.HaloPartition`
    :arg build_eq: callable ``(submesh, partition_index) -> equation``;
        builds the full serial stack (FunctionSpace / assembler /
        equation) on the given SubMesh, slicing any per-cell / per-vertex
        coefficient data with ``partition.local_cell_values`` /
        ``partition.local_vertex_values``.

    The partitions live on ``partition.devices``.  State and residuals
    are striped-global cell tensors ``(nc, nd, ...)`` in
    ``partition.perm`` order (``partition.scatter_cells`` /
    ``gather_cells`` convert) on the first partition's device.
    ``fields`` is either

    * a dict, as in the reference: scalars / 0-d tensors (shared) and
      striped-global per-cell tensors with leading dim ``nc``
      (halo-refreshed like the state); any other tensor is refused, as is
      every non-scalar field of a mesh with ``nv == nc`` (a vertex field
      and a cell field cannot be told apart there); or
    * a list of one dict a partition, each on that partition's extended
      rows and vertices, as its own instance gathers them (a CG1
      coefficient such as a beta-plane Coriolis, built from
      ``partition.local_vertex_values``).

    BC values must be scalars or 0-d, as in the reference.
    """

    def __init__(self, partition, build_eq):
        self.partition = partition
        self.devices = partition.devices
        self.eqs = [build_eq(sm, d)
                    for d, sm in enumerate(partition.submeshes)]
        self.template = self.eqs[0]

    # -- helpers ---------------------------------------------------------
    def device_put(self, tree):
        """A striped-global dict of arrays as tensors on the container's
        device (the identity for tensors already there)."""
        dev, dtype = self.devices[0], self.partition.mesh.dtype

        def put(v):
            if isinstance(v, torch.Tensor):
                return v.to(dev)
            a = np.asarray(v)
            return torch.as_tensor(
                a, dtype=dtype if a.dtype.kind == "f" else None, device=dev)

        return {k: put(v) for k, v in tree.items()}

    def _split_fields(self, fields):
        """Split a fields dict into (striped per-cell, shared) parts;
        a tensor of any other shape is refused."""
        mesh = self.partition.mesh
        sharded, repl = {}, {}
        for k, v in (fields or {}).items():
            if getattr(v, "ndim", 0) == 0:
                repl[k] = v
            elif v.shape[0] == mesh.nc and mesh.nv != mesh.nc:
                sharded[k] = v
            else:
                raise ValueError(
                    f"field {k!r} of shape {tuple(v.shape)} is not a "
                    f"striped cell field of this mesh (nc {mesh.nc}, nv "
                    f"{mesh.nv}): give a list of per-partition fields")
        return sharded, repl

    def local_fields(self, fields, d):
        """Partition d's fields: from a list, its own dict; from a dict,
        the per-cell ones halo-extended and the rest shared."""
        dev = self.devices[d]
        if isinstance(fields, (list, tuple)):
            return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                    for k, v in fields[d].items()}
        cells, rest = self._split_fields(fields)
        out = {k: halo_extend(self.partition, torch.as_tensor(v), d)
               for k, v in cells.items()}
        for k, v in rest.items():
            out[k] = v.to(dev) if isinstance(v, torch.Tensor) else v
        return out

    def local_bnd(self, bnd_values, d):
        """Partition d's BC values (scalars or 0-d; any other value is
        refused: per-facet data does not partition)."""
        dev = self.devices[d]
        out = {}
        for m, spec in (bnd_values or {}).items():
            out[m] = {}
            for k, v in spec.items():
                if getattr(v, "ndim", 0) != 0:
                    raise ValueError(
                        f"BC value {k!r} of marker {m} has shape "
                        f"{tuple(v.shape)}: the partitioned equation takes "
                        "scalar or 0-d BC values")
                out[m][k] = v.to(dev) if isinstance(v, torch.Tensor) else v
        return out

    def local_state(self, tree, d):
        """Partition d's halo-extended rows of a striped-global dict."""
        return {k: halo_extend(self.partition, v, d) for k, v in tree.items()}

    def gather_owned(self, parts):
        """Per-partition dicts of extended rows -> the striped-global dict
        of their owned rows (on the first partition's device)."""
        n_loc, dev = self.partition.n_loc, self.devices[0]
        return {k: torch.cat([p[k][:n_loc].to(dev) for p in parts], dim=0)
                for k in parts[0]}

    # -- partitioned evaluation ----------------------------------------
    def residual(self, label, solution, solution_old, fields, fields_old,
                 bnd_values):
        out = []
        for d, eq in enumerate(self.eqs):
            sol = self.local_state(solution, d)
            sol_old = (sol if solution_old is solution
                       else self.local_state(solution_old, d))
            f = self.local_fields(fields, d)
            fo = f if fields_old is fields else self.local_fields(
                fields_old, d)
            out.append(eq.residual(label, sol, sol_old, f, fo,
                                   self.local_bnd(bnd_values, d)))
        return self.gather_owned(out)

    def _cellwise(self, method, solution):
        return self.gather_owned([
            getattr(eq, method)(self.local_state(solution, d))
            for d, eq in enumerate(self.eqs)])

    def mass_term(self, solution):
        return self._cellwise("mass_term", solution)

    def mass_inverse(self, r):
        return self._cellwise("mass_inverse", r)
