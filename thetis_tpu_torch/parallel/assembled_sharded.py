r"""Partitioned assembled-Jacobian KSP: the fast implicit-SWE path over a
halo partition (port of ``thetis_tpu/parallel/assembled_sharded.py``).

The reference's scalable implicit story is PETSc KSP on the assembled
Jacobian over the decomposed mesh: each rank assembles its owned rows,
every Krylov matvec does one halo refresh, block-Jacobi preconditioning
is per rank, and dot products allreduce (ref ``options.py:44-48``,
``'snes_type': 'ksponly', 'pc_type': 'bjacobi'``).  Here:

* each partition assembles its blocks analytically on its
  halo-extended lagged state, in the component-major layout
  ``(4, 9, 9, n_ext)`` the ring kernel reads (owned and ghost rows; the
  ghost rows are never used);
* every matvec refreshes the Krylov vector's halo
  (:func:`~.shard.halo_extend`) and runs the ring matvec
  (:func:`~thetis_tpu_torch.kernels.ringmv.ring_mv`, the CUDA kernel on
  the card) over the partition's ``n_ext`` extended rows, keeping the
  first ``n_loc`` (the kernel reads and writes ``nc`` rows of one table,
  so the ghost rows are ``2 halo / n_loc`` extra work);
* every block-Jacobi apply is
  :func:`~thetis_tpu_torch.kernels.ringmv.block_diag_mv` on the owned
  rows' inverted diagonal blocks;
* every dot product and norm is the sum of the partitions' partials in
  partition order (:func:`~.shard.allreduce`, through the ``allreduce``
  hook of :func:`thetis_tpu_torch.solvers.newton._fgmres_flat`, the
  Krylov core the serial path runs).

The Krylov container is ``(D, 9, n_loc)``: row d is partition d's owned
vector, component-major.  The depth-2 vertex-closure halos give the
owned-row blocks exact 1-ring data.
"""
import torch

from ..kernels.ringmv import block_diag_mv, ring_mv
from ..solvers.assembled import (CoarseCorrection, PackedState,
                                 aggregate_segments, batched_inv_small_T,
                                 restrict, ring_tables)
from ..solvers.newton import NewtonParameters, _fgmres_flat, _partitioned
from ..timeintegration.steppers import _tree_lc
from .shard import allreduce, halo_extend

__all__ = ["ShardedAssembledCN", "DistributedCoarseCorrection"]


class DistributedCoarseCorrection:
    """Galerkin coarse correction over a partition.

    The coarse space is global (piecewise-constant per cell aggregate,
    exactly :class:`~thetis_tpu_torch.solvers.assembled.CoarseCorrection`);
    the restriction is a per-partition sorted segment sum over owned cells
    followed by one :func:`~.shard.allreduce` of the (small) coarse
    residual, the coarse solve is the serial coarse inverse, and the
    prolongation is a per-partition gather.  Set-up reuses the SERIAL
    coarse operator built from the global blocks, so the partitioned
    correction equals the serial one up to the order of the restriction's
    sums.
    """

    def __init__(self, serial_coarse, partition):
        self.n_agg = serial_coarse.n_agg
        self.d = serial_coarse.d
        self.nd_c = serial_coarse.nd_c
        dev0 = partition.devices[0]
        self.Ac_inv = serial_coarse.Ac_inv.to(dev0)
        self.F = None if serial_coarse.F is None else serial_coarse.F.to(
            dev0)
        # each partition's aggregate ids of its OWNED cells
        agg_striped = serial_coarse.agg.cpu().numpy()[partition.perm]
        n_loc = partition.n_loc
        self.agg = []
        self.segments = []
        for d, dev in enumerate(partition.devices):
            agg_d = agg_striped[d * n_loc:(d + 1) * n_loc]
            self.agg.append(torch.as_tensor(agg_d, device=dev))
            self.segments.append(aggregate_segments(agg_d, self.n_agg, dev))

    def apply(self, r_owned):
        """Per-partition owned residuals, cell-major ``[(n_loc, d), ...]``
        -> per-partition coarse-corrected increments."""
        r_c = allreduce([restrict(r, seg)
                         for r, seg in zip(r_owned, self.segments)])
        if self.F is not None:
            r_c = r_c @ self.F
        z_c = (self.Ac_inv @ r_c.reshape(-1)).reshape(self.n_agg, self.nd_c)
        if self.F is not None:
            z_c = z_c @ self.F.T
        return [z_c.to(agg.device)[agg] for agg in self.agg]


class ShardedAssembledCN:
    """Partitioned semi-implicit CrankNicolson over an assembled-KSP
    solve (drop-in for the ``steppers.CrankNicolson`` the partitioned
    barotropic mode otherwise runs matrix-free).

    :arg sharded_eq: a :class:`~.sharded.ShardedEquation` whose equations
        support ``assemble_operator_blocks`` (``ShallowWaterEquations`` /
        ``ModeSplit2DEquations``)
    :arg dt: time step
    :kwarg theta: implicitness parameter
    :kwarg solver_parameters: NewtonParameters (ksp_rtol / restart /
        ksp_max_it are honoured)
    :kwarg coarse: optional serial
        :class:`~thetis_tpu_torch.solvers.assembled.CoarseCorrection`
        built from the GLOBAL rest-state blocks; applied partitioned in
        the two-level multiplicative V-cycle of the serial solve (any other
        preconditioner object falls back to block-Jacobi, as in the
        reference)
    """

    def __init__(self, sharded_eq, dt, theta=0.5, solver_parameters=None,
                 coarse=None):
        self.eq_sh = sharded_eq
        self.dt = float(dt)
        self.theta = float(theta)
        self.semi_implicit = True
        self.params = solver_parameters or NewtonParameters()
        part = sharded_eq.partition
        self.partition = part
        self.rings = []
        for sm in part.submeshes:
            ring, valid = ring_tables(sm)
            lo, hi = int(ring.min()), int(ring.max())
            if lo < 0 or hi >= part.n_ext:
                raise AssertionError(
                    f"ring table of {sm.name} indexes [{lo}, {hi}], outside "
                    f"its {part.n_ext} extended rows")
            self.rings.append((ring, valid))
        if coarse is not None and not isinstance(coarse, CoarseCorrection):
            coarse = None
        self.coarse = (DistributedCoarseCorrection(coarse, part)
                       if coarse is not None else None)
        #: counters of the last ``advance``
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values,
                linearization_state=None):
        eq_sh = self.eq_sh
        part = self.partition
        n_loc, D = part.n_loc, part.n_devices
        dt, th = self.dt, self.theta
        params = self.params
        same_fields = fields is fields_old
        blocks, diag_inv, f_old, x_old = [], [], [], []
        for d, eq in enumerate(eq_sh.eqs):
            sol_e = eq_sh.local_state(solution, d)
            f_all = eq_sh.local_fields(fields, d)
            bnd = eq_sh.local_bnd(bnd_values, d)
            ps = PackedState(sol_e)
            # analytic assembly on the halo-extended lagged state (owned
            # and ghost rows; ghost rows are never read)
            if same_fields and linearization_state is None:
                bT, r_lag = eq.assemble_operator_blocks(
                    sol_e, f_all, bnd, th * dt, return_residual=True)
                f_d = ps.pack(_tree_lc([(-dt, r_lag)]))
            else:
                fo_all = eq_sh.local_fields(fields_old, d)
                lag = (eq_sh.local_state(linearization_state, d)
                       if linearization_state is not None else sol_e)
                bT = eq.assemble_operator_blocks(lag, f_all, bnd, th * dt)
                m_old = eq.mass_term(sol_e)
                r_expl = eq.residual("all", sol_e, sol_e, fo_all, fo_all,
                                     bnd)
                r_impl = eq.residual("all", sol_e, lag, f_all, f_all, bnd)
                f_d = ps.pack(_tree_lc([
                    (1.0, eq.mass_term(sol_e)), (-th * dt, r_impl),
                    (-1.0, m_old), (-(1 - th) * dt, r_expl)]))
            blocks.append(bT)
            diag_inv.append(batched_inv_small_T(bT[0][..., :n_loc]))
            f_old.append(f_d[:n_loc].T)
            x_old.append(ps.pack(sol_e)[:n_loc].T)
        dev0 = part.devices[0]
        r0 = -torch.stack([f.to(dev0) for f in f_old])   # (D, d, n_loc)
        x_old = torch.stack([x.to(dev0) for x in x_old])
        nd = r0.shape[1]

        def mv3(x3):
            """(D, d, n_loc) -> (D, d, n_loc): each partition's ring
            matvec over its extended rows, owned rows kept."""
            out = []
            for p in range(D):
                ring, valid = self.rings[p]
                y = ring_mv(blocks[p], halo_extend(part, x3, p, blocked=True),
                            ring, valid)
                out.append(y[:, :n_loc].to(dev0))
            return torch.stack(out)

        def bjac3(r3):
            return torch.stack([
                block_diag_mv(diag_inv[p], r3[p].to(diag_inv[p].device))
                .to(dev0) for p in range(D)])

        def mv(v):
            return mv3(v.view(D, nd, n_loc)).view(D, -1)

        coarse = self.coarse
        if coarse is None:
            def M(v):
                return bjac3(v.view(D, nd, n_loc)).view(D, -1)
        else:
            def coarse3(r3):
                z = coarse.apply([r.T for r in r3])
                return torch.stack([zp.T.to(dev0) for zp in z])

            def M(v):
                r = v.view(D, nd, n_loc)
                z = bjac3(r)
                z = z + coarse3(r - mv3(z))
                z = z + bjac3(r - mv3(z))
                return z.view(D, -1)

        _, norm, _ = _partitioned(allreduce)
        # warm start from the lagged state: solve the residual system
        # A dx = -F(u_old), anchored to ||b||
        tiny = torch.finfo(r0.dtype).tiny
        bnorm = float(norm((mv3(x_old) + r0).view(D, -1)))
        rtol_eff = (params.ksp_rtol * bnorm
                    / max(float(norm(r0.view(D, -1))), tiny))
        stats = {}
        self.stats = stats
        dx, rnorm, _ = _fgmres_flat(
            mv, r0.reshape(D, -1), M, rtol_eff, params.gmres_restart,
            max(1, params.ksp_max_it // params.gmres_restart), stats,
            allreduce=allreduce)
        x = x_old + dx.view(D, nd, n_loc)
        stats["ksp_rel_residual"] = rnorm / max(bnorm, tiny)
        if rnorm > 1e4 * max(bnorm, tiny):
            x = torch.full_like(x, float("nan"))
        # (D, d, n_loc) -> striped-global cell-major (nc, d)
        return PackedState(solution).unpack(
            x.permute(0, 2, 1).reshape(D * n_loc, nd))
