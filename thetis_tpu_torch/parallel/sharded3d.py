r"""Partitioned 3D baroclinic step (port of
``thetis_tpu/parallel/sharded3d.py``).

The reference's parallel execution model (SURVEY.md section 2.10): the
horizontal mesh is domain-decomposed, every vertical column stays local to
its partition, and one halo refresh precedes each RHS evaluation.  The
mode-split structure maps onto two levels:

* the **cell/column-local phases** (baroclinicity, ALE geometry, 3D
  advection, vertical-implicit mixing on the tridiagonal kernel,
  turbulence, 2D<->3D coupling) run per partition, on that partition's
  own serial ``FlowSolver`` (its ``_pre_fn`` / ``_post_fn``) over its
  halo-extended state;
* the **implicit barotropic solve** runs at the global level through a
  :class:`~.sharded.ShardedEquation` over the partitions' ``eq_sw``:
  :class:`~.assembled_sharded.ShardedAssembledCN` when the serial stepper
  assembles (ring matvec and block-Jacobi kernels per partition, Krylov
  reductions through :func:`~.shard.allreduce`), else the serial
  ``CrankNicolson`` over the ShardedEquation.
"""
import torch

from ..timeintegration.steppers import CrankNicolson
from .assembled_sharded import ShardedAssembledCN
from .shard import halo_extend
from .sharded import ShardedEquation

__all__ = ["ShardedFlowSolver3d"]


class ShardedFlowSolver3d:
    r"""Partitioned adapter around per-partition serial ``FlowSolver``\ s.

    :arg partition: :class:`~.submesh.HaloPartition` of the 2D mesh
    :arg build_solver: ``(submesh, partition_index) -> FlowSolver``; builds
        AND ``initialize()``\ s a serial 3D solver on the SubMesh, slicing
        bathymetry with ``partition.local_vertex_values`` /
        ``local_cell_values``

    ``step(state, swe_fields, bnd_sw)`` advances one mode-split step on
    striped-global state tensors (``partition.perm`` order).
    ``swe_fields`` are as :class:`ShardedEquation` takes them: a dict of
    scalars and striped cell tensors, or a list of per-partition dicts,
    such as :meth:`gather_swe_fields` gives.  BC values must be scalars
    or 0-d.
    """

    def __init__(self, partition, build_solver):
        self.partition = partition
        self.solvers = [build_solver(sm, d)
                        for d, sm in enumerate(partition.submeshes)]
        self.template = self.solvers[0]
        if int(getattr(self.template, "M_modesplit", 1) or 1) > 1:
            raise NotImplementedError(
                "dt_mode='split' subcycling is serial-only; use the "
                "implicit 2D mode (dt_mode='3d') for partitioned runs")
        # global-level partitioned 2D SWE stepper over the partitions'
        # eq_sw instances (the serial swe_stepper's settings are reused)
        self.sharded_swe = ShardedEquation(
            partition, lambda sm, d: self.solvers[d].eq_sw)
        ser = self.template.swe_stepper
        if getattr(ser, "assembled_solve", False):
            self.swe_stepper = ShardedAssembledCN(
                self.sharded_swe, ser.dt, theta=ser.theta,
                solver_parameters=ser.params, coarse=ser.coarse)
        else:
            self.swe_stepper = CrankNicolson(
                self.sharded_swe, ser.dt, theta=ser.theta,
                semi_implicit=ser.semi_implicit,
                solver_parameters=ser.params)

    def device_put(self, tree):
        return self.sharded_swe.device_put(tree)

    def _owned(self, parts):
        """Per-partition extended tensors -> striped-global owned rows."""
        n_loc, dev = self.partition.n_loc, self.partition.devices[0]
        return torch.cat([p[:n_loc].to(dev) for p in parts], dim=0)

    def gather_swe_fields(self):
        """Each partition's 2D-mode fields from its own solver
        (``_gather_swe_fields()``: its options on its rows and vertices),
        as a list :meth:`step` takes."""
        return [s._gather_swe_fields() for s in self.solvers]

    def step(self, state, swe_fields, bnd_sw):
        """One partitioned mode-split step (the serial ``FlowSolver._step``
        up to the order of the Krylov reductions)."""
        sh, part = self.sharded_swe, self.partition
        D = part.n_devices
        states = [sh.local_state(state, d) for d in range(D)]
        fields = [sh.local_fields(swe_fields, d) for d in range(D)]
        pre = [s._pre_fn(states[d]) for d, s in enumerate(self.solvers)]
        geom0 = [p[0] for p in pre]
        int_pg = (None if pre[0][1] is None
                  else self._owned([p[1] for p in pre]))
        src_2d = (None if pre[0][2] is None
                  else self._owned([p[2] for p in pre]))
        # the barotropic solve's fields, per partition: the depth-averaged
        # sources on the owners' rows, halo-refreshed
        sf = []
        for d, f in enumerate(fields):
            src = (None if src_2d is None
                   else halo_extend(part, src_2d, d))
            user = f.get("momentum_source_user")
            if user is not None:
                src = user if src is None else src + user
            sf.append(f if src is None else dict(f, momentum_source=src))
        sw = self.swe_stepper.advance(
            0.0, {"uv": state["uv"], "elev": state["elev"]}, sf, sf, bnd_sw)
        out = []
        for d, s in enumerate(self.solvers):
            ipg = None if int_pg is None else halo_extend(part, int_pg, d)
            out.append(s._post_fn(states[d], sh.local_state(sw, d),
                                  geom0[d], ipg, sf[d]))
        return sh.gather_owned(out)
