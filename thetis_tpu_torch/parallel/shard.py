r"""Partitions, their halo refresh and their reductions (port of
``thetis_tpu/parallel/shard.py``).

The execution model is the reference's: each partition owns a stripe of
cells; before each RHS evaluation its ghost-cell dofs are refreshed from
its two ring neighbours (the PyOP2 halo exchange); facet and cell
integrals then run exactly as in the serial scatter-free formulation on
the partition's own tables.  Scalar reductions (norms, dot products)
sum per-partition partials.

One process drives every partition here, as one controller drives every
device through ``shard_map`` in the reference.  Partitioned state is a
*striped-global* tensor: the ``nc`` cells in ``partition.perm`` order,
partition d's owned rows ``[d n_loc, (d+1) n_loc)``.  Two functions carry
all data motion between partitions:

* :func:`halo_exchange` (and its partition-level form
  :func:`halo_extend`) returns ``[owned | ghosts from the left neighbour
  | ghosts from the right neighbour]`` of one partition, the counterpart
  of the reference's two ``ppermute``\ s;
* :func:`allreduce` sums per-partition partials in partition order (so
  the sum has the same bits on every run), the counterpart of
  ``lax.psum``.

No other code reads another partition's rows.  Partitions on several
GPUs replace these two functions and the striped container (a process
group's transport), and nothing else.
"""
import numpy as np
import torch

__all__ = ["make_device_mesh", "halo_exchange", "halo_extend", "allreduce",
           "sharded_tracer_advection"]


def make_device_mesh(n_devices, devices=None):
    """The devices of ``n_devices`` partitions: by default the first
    ``n_devices`` CUDA devices (the reference takes ``jax.devices()[:n]``);
    ``devices`` (e.g. ``[torch.device("cuda")] * 4``, one card standing in
    for four, or ``["cpu"] * 8``) gives them explicitly."""
    n = int(n_devices)
    if devices is None:
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"{n} partitions need {n} CUDA devices, "
                f"{torch.cuda.device_count()} present; pass devices= to put "
                "several partitions on one device")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"{len(devices)} devices for {n} partitions")
    return devices[:n]


def _ext_rows(send_left, send_right, n_loc, d):
    """(n_ext,) striped-global row behind each slot of partition d's
    extended array: its owned rows, then the left neighbour's rows it
    sends right, then the right neighbour's rows it sends left."""
    D = len(send_left)
    left, right = (d - 1) % D, (d + 1) % D
    return np.concatenate([
        np.arange(d * n_loc, (d + 1) * n_loc),
        left * n_loc + np.asarray(send_right[left], np.int64),
        right * n_loc + np.asarray(send_left[right], np.int64)])


def halo_exchange(u, d, send_left, send_right, n_loc, rows=None):
    """Partition d's extended array ``[owned | ghost_from_left |
    ghost_from_right]`` from the striped-global tensor ``u`` (its leading
    axis holds the cells in partition order).

    ``send_left/right``: (D, halo) local indices of each partition's owned
    cells shipped to its ring neighbours.  ``rows`` (optional) is
    :func:`_ext_rows` as a tensor on ``u``'s device, when the caller
    keeps it."""
    if rows is None:
        rows = torch.as_tensor(_ext_rows(send_left, send_right, n_loc, d),
                               device=u.device)
    return u.index_select(0, rows)


def _rows_on(partition, d, device):
    cache = partition.__dict__.setdefault("_halo_rows", {})
    key = (d, str(device))
    if key not in cache:
        rows = _ext_rows(partition.send_left, partition.send_right,
                         partition.n_loc, d)
        cache[key] = (torch.as_tensor(rows, device=device),
                      torch.as_tensor(rows // partition.n_loc, device=device),
                      torch.as_tensor(rows % partition.n_loc, device=device))
    return cache[key]


def halo_extend(partition, u, d, blocked=False):
    """Partition d's halo-extended rows of a striped-global tensor ``u``
    (``(nc, ...)`` -> ``(n_ext, ...)``), on the partition's device.

    ``blocked=True`` takes the Krylov container of the sharded assembled
    solve instead: ``u`` (D, k, n_loc), partition p's component-major
    owned vector in row p, -> (k, n_ext), component-major and contiguous
    (one gather)."""
    dev = partition.devices[d]
    rows, part, cell = _rows_on(partition, d, u.device)
    if blocked:
        out = u.permute(1, 0, 2)[:, part, cell]
    else:
        out = halo_exchange(u, d, partition.send_left, partition.send_right,
                            partition.n_loc, rows=rows)
    return out.to(dev)


def allreduce(parts):
    """The sum of per-partition partials in partition order: ``parts`` is
    a sequence (a list, or a tensor's leading axis) with partition d's
    partial at position d; the result is on the first partial's device."""
    it = iter(parts)
    total = next(it)
    for p in it:
        total = total + p.to(total.device)
    return total


def _tracer_advection_local(c_ext, uv_ext, t, phi, phi_f, qw, qwf, dphi):
    """Partition-local upwind advection residual on extended arrays.

    ``t``: the partition's tables (facet_cells indexed into the extended
    array; see StripePartition) with ``detJ_ext`` / ``Jinv_ext``."""
    # cell term: R_grad += c * uv tested against grad(test)
    c_q = torch.einsum("qd,cd->cq", phi, c_ext)
    uv_q = torch.einsum("qd,cdk->cqk", phi, uv_ext)
    # physical divergence: du_k/dx_i = dphi Jinv
    guv = torch.einsum("qdj,cji,cdk->cqki", dphi, t["Jinv_ext"], uv_ext)
    div_uv = guv[..., 0, 0] + guv[..., 1, 1]
    wdetJ = qw[None, :] * t["detJ_ext"][:, None]

    acc_cell = c_q * div_uv
    acc_grad = c_q[..., None] * uv_q

    # facet terms
    fc = t["facet_cells"]
    tabs0 = phi_f[t["facet_variant"][:, 0]]
    tabs1 = phi_f[t["facet_variant"][:, 1]]
    c0 = torch.einsum("fqd,fd->fq", tabs0, c_ext[fc[:, 0]])
    c1 = torch.einsum("fqd,fd->fq", tabs1, c_ext[fc[:, 1]])
    u0 = torch.einsum("fqd,fdk->fqk", tabs0, uv_ext[fc[:, 0]])
    u1 = torch.einsum("fqd,fdk->fqk", tabs1, uv_ext[fc[:, 1]])
    n = t["facet_normal"][:, None, :]
    un0 = (u0 * n).sum(-1)
    un1 = (u1 * n).sum(-1)
    un_av = 0.5 * (un0 + un1)
    s = 0.5 * (torch.sign(un_av) + 1.0)
    c_up = c0 * s + c1 * (1 - s)
    mi = t["facet_mask_int"][:, None]
    mb = t["facet_mask_bnd"][:, None]
    f0 = (-c_up * un0) * mi + (-c0 * un0) * mb
    f1 = (c_up * un1) * mi
    # LF stabilisation
    gamma = 0.5 * torch.abs(un_av)
    f0 = f0 + gamma * (c1 - c0) * mi
    f1 = f1 - gamma * (c1 - c0) * mi
    wlen = qwf[None, :] * t["facet_len"][:, None]
    contrib0 = torch.einsum("fq,fqd->fd", f0 * wlen, tabs0)
    contrib1 = torch.einsum("fq,fqd->fd", f1 * wlen, tabs1)
    contrib = torch.stack([contrib0, contrib1], dim=1)
    g2 = contrib[t["cell_facets"], t["cell_sides"]].sum(dim=1)

    n_loc = t["cell_facets"].shape[0]
    accw_c = (acc_cell * wdetJ)[:n_loc]
    r = torch.einsum("cq,qd->cd", accw_c, phi)
    accw_g = (acc_grad * wdetJ[..., None])[:n_loc]
    r = r + torch.einsum("cqi,qdj,cji->cd", accw_g, dphi,
                         t["Jinv_ext"][:n_loc])
    return r + g2


def sharded_tracer_advection(partition, space, device_mesh=None):
    """The distributed RHS ``f(c, uv) -> r`` of 2D upwind tracer advection
    over a :class:`~.partition.StripePartition`, on ``(D, n_loc, ...)``
    tensors (``partition.scatter_cells``; striped-global once flattened):
    each partition refreshes its halo, evaluates its facets and cells, and
    keeps its owned rows.
    ``device_mesh``: the partitions' devices (:func:`make_device_mesh`;
    default the space's mesh device for each)."""
    D, n_loc = partition.n_devices, partition.n_loc
    devices = (list(device_mesh) if device_mesh is not None
               else [space.mesh.device] * D)
    dtype = space.mesh.dtype
    tabs = space._tab_np

    def on(dev, a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            return torch.as_tensor(a, dtype=dtype, device=dev)
        if a.dtype.kind == "b":
            return torch.as_tensor(a, device=dev)
        return torch.as_tensor(a.astype(np.int64), device=dev)

    basis = [{k: on(dev, tabs[k]) for k in ("phi", "dphi", "phi_f", "qw",
                                            "qwf")} for dev in devices]
    tables = [{k: on(devices[d], v[d]) for k, v in partition.tables.items()
               if k not in ("detJ", "Jinv", "send_left", "send_right")}
              for d in range(D)]
    sl, sr = partition.tables["send_left"], partition.tables["send_right"]
    geom = {k: on(devices[0], partition.tables[k].reshape(
        (D * n_loc,) + partition.tables[k].shape[2:]))
        for k in ("detJ", "Jinv")}

    def rhs(c, uv):
        c = c.reshape((D * n_loc,) + tuple(c.shape[2:]))
        uv = uv.reshape((D * n_loc,) + tuple(uv.shape[2:]))
        out = []
        for d in range(D):
            dev = devices[d]

            def ext(u):
                return halo_exchange(u, d, sl, sr, n_loc).to(dev)

            t = dict(tables[d], detJ_ext=ext(geom["detJ"]),
                     Jinv_ext=ext(geom["Jinv"]))
            b = basis[d]
            out.append(_tracer_advection_local(
                ext(c), ext(uv), t, b["phi"], b["phi_f"], b["qw"], b["qwf"],
                b["dphi"]).to(c.device))
        return torch.stack(out)

    return rhs
