r"""Analytic ring-block assembly of the semi-implicit SWE operator.

Port of ``thetis_tpu/equations/swe_blocks.py``.  Every SWE term is
pointwise in the quadrature sites: cell buckets depend only on the quad
values ``(uv_q, eta_q, grad uv_q)`` at the same (cell, q), and facet
buckets only on the traces ``(uv_tr, eta_tr, grad uv_tr)`` at the same
(facet, side, q).  The Jacobian therefore factorizes

    dR/du = P^T  (dB/dvals)  E

with ``E`` the (static) dof->value tabulations and ``P`` the (static)
value->dof projections.  ``dB/dvals`` comes from 7 cell + 14 trace
value-space unit tangents pushed through the term algebra with
``torch.func.jvp`` under ``torch.func.vmap``.

The basis contraction is written as batched small matrix products with
the mesh axis leading: per (cell, q) ``Eout^T J E7`` and per
(facet, side, side, q) the same with the trace tabulations.  (The
reference unrolls it into ~10k slab multiply-adds because the TPU pads
the two tiny minor axes of such products; eager PyTorch would pay one
launch per slab op.)  The blocks come out in the component-major
``(4, 9, 9, nc)`` ring layout the CUDA ring matvec reads.

Packed dof layout per cell: ``[eta(3), u/v interleaved(6)]`` (the
reference's PackedState order, sorted dict keys).
"""
import numpy as np
import torch

from .base import Bucket

__all__ = ["assemble_swe_blocks", "swe_mass_blocks"]


# value-space probe layout (cell and per trace side):
#   k = [u, v, eta, du/dx, du/dy, dv/dx, dv/dy]
_NKC = 7
_NKF = 7


def _bucket_fn(eq, base_c, label):
    """Return f(vals) -> tuple of bucket tensors, with vals the implicit
    value-space inputs; everything else (lagged state, fields, BC data)
    is closed over from ``base_c``."""
    def f(vals):
        uv_q, eta_q, grad_q, uv_tr, eta_tr, grad_tr = vals
        c = dict(base_c)
        c["uv_q"], c["eta_q"], c["uv_grad_q"] = uv_q, eta_q, grad_q
        c["uv_tr"], c["eta_tr"], c["uv_grad_tr"] = uv_tr, eta_tr, grad_tr
        c["eta_ext"], c["uv_ext"] = eq._bnd_ext(
            eta_tr[:, 0], uv_tr[:, 0], c["bnd_values"], c["bathy_tr"][:, 0])
        B = {k: Bucket() for k in (
            "uv_cell", "uv_grad", "uv_facet", "uv_fgrad",
            "eta_cell", "eta_grad", "eta_facet")}
        for _, method in eq.select_terms(label):
            method(c, B)
        nc, nq = uv_q.shape[:2]
        nf, _, nqf = eta_tr.shape

        def val(name, shape):
            b = B[name]
            return b.val if b else uv_q.new_zeros(shape)

        return (
            val("uv_cell", (nc, nq, 2)),
            val("uv_grad", (nc, nq, 2, 2)),
            val("eta_cell", (nc, nq)),
            val("eta_grad", (nc, nq, 2)),
            val("uv_facet", (nf, 2, nqf, 2)),
            val("uv_fgrad", (nf, 2, nqf, 2, 2)),
            val("eta_facet", (nf, 2, nqf)),
        )
    return f


def _probe_basis_cell(nc, nq, like):
    """The 7 cell value-space unit tangents on a leading axis, as
    broadcast views of tiny patterns."""
    P = _NKC
    zc2 = np.zeros((P, 1, 1, 2))
    zc1 = np.zeros((P, 1, 1))
    zc4 = np.zeros((P, 1, 1, 2, 2))
    for a in range(2):
        zc2[a, ..., a] = 1.0
    zc1[2] = 1.0
    for a in range(2):
        for i in range(2):
            zc4[3 + 2 * a + i, ..., a, i] = 1.0

    def bc(z, shape):
        return like.new_tensor(z).expand((P,) + shape)

    return (bc(zc2, (nc, nq, 2)), bc(zc1, (nc, nq)),
            bc(zc4, (nc, nq, 2, 2)))


def _probe_basis_trace(nf, nqf, like):
    """The 2 sides x 7 trace value-space unit tangents on a leading axis
    (local index ``si * 7 + k``)."""
    P = 2 * _NKF
    zf2 = np.zeros((P, 1, 2, 1, 2))
    zf1 = np.zeros((P, 1, 2, 1))
    zf4 = np.zeros((P, 1, 2, 1, 2, 2))
    for s in range(2):
        o = s * _NKF
        for a in range(2):
            zf2[o + a, :, s, :, a] = 1.0
        zf1[o + 2, :, s, :] = 1.0
        for a in range(2):
            for i in range(2):
                zf4[o + 3 + 2 * a + i, :, s, :, a, i] = 1.0

    def bc(z, shape):
        return like.new_tensor(z).expand((P,) + shape)

    return (bc(zf2, (nf, 2, nqf, 2)), bc(zf1, (nf, 2, nqf)),
            bc(zf4, (nf, 2, nqf, 2, 2)))


def _interleave(a, b):
    """[..., 3], [..., 3] -> [..., 6] as [a0, b0, a1, b1, a2, b2] — the
    packed uv column layout (dof-major, component-minor)."""
    return torch.stack([a, b], dim=-1).reshape(a.shape[:-1] + (6,))


def _basis_rows(T, G):
    """Basis matrices in the packed column layout [eta(3), uv(6)].

    :arg T: value tabulation (..., 3)
    :arg G: gradient tabulation (..., 3, 2)
    :returns: (E7, Eg2): E7 (..., 7, 9) rows [u, v, eta, du/dx, du/dy,
        dv/dx, dv/dy]; Eg2 (..., 2, 9) the eta-gradient rows (out side
        only: no implicit term reads grad(eta))."""
    z3 = torch.zeros_like(T)
    z6 = T.new_zeros(T.shape[:-1] + (6,))

    def urow(t):
        return torch.cat([z3, _interleave(t, z3)], dim=-1)

    def vrow(t):
        return torch.cat([z3, _interleave(z3, t)], dim=-1)

    erow = torch.cat([T, z6], dim=-1)
    E7 = torch.stack([
        urow(T), vrow(T), erow,
        urow(G[..., 0]), urow(G[..., 1]),
        vrow(G[..., 0]), vrow(G[..., 1]),
    ], dim=-2)
    Eg2 = torch.stack([
        torch.cat([G[..., 0], z6], dim=-1),
        torch.cat([G[..., 1], z6], dim=-1),
    ], dim=-2)
    return E7, Eg2


def swe_mass_blocks(eq, dtype):
    """Packed diagonal blocks of the mass operator, component-major
    (9, 9, nc): the DG mass matrix per component."""
    asm = eq.asm
    mesh = asm.mesh
    Mc = np.asarray(asm._Mref_np)                        # (nd, nd)
    Mfull = np.zeros((9, 9), Mc.dtype)
    Mfull[:3, :3] = Mc
    for dt_ in range(3):
        for et in range(3):
            for a in range(2):
                Mfull[3 + 2 * dt_ + a, 3 + 2 * et + a] = Mc[dt_, et]
    detJ = mesh.detJ.to(dtype)
    return detJ.new_tensor(Mfull)[:, :, None] * detJ


def _project_buckets(eq, f0):
    """Project value-space buckets to dof space: the tail of
    ``ShallowWaterEquations.residual`` applied to the primal buckets, so
    the stepper's explicit residual comes with the assembly."""
    asm = eq.asm
    uc, ug, ec, eg, uf, fg, ef = f0
    rr = asm.cell_to_dofs(torch.cat([uc, ec[..., None]], dim=-1))
    r_uv = rr[..., 0:2]
    r_eta = rr[..., 2]
    rr = asm.grad_to_dofs(torch.cat([ug, eg[..., None, :]], dim=-2))
    r_uv = r_uv + rr[..., 0:2]
    r_eta = r_eta + rr[..., 2]
    packed = torch.cat([uf, ef[..., None]], dim=-1)
    rr = asm.facet_fgrad_to_dofs(packed, fg)
    r_uv = r_uv + rr[..., 0:2]
    r_eta = r_eta + rr[..., 2]
    return {"uv": r_uv, "elev": r_eta}


def assemble_swe_blocks(eq, u_lag, fields, bnd_values, coeff,
                        return_residual=False):
    """Assembled ring blocks of the semi-implicit operator

        A = M  -  coeff * dR/du |_(u_lag)

    (``coeff = theta*dt`` for CrankNicolson; the semi-implicit residual is
    linear given the lagged state, so these blocks are exact).  Returns
    component-major ``(4, 9, 9, nc)`` blocks in the ``cell_ring`` slot
    layout, boundary-mirror slots folded into the diagonal (slot 0) and
    zeroed.

    With ``return_residual`` also returns ``R(u_lag)`` (an swe_state
    dict, equal to ``eq.residual("all", u_lag, u_lag, fields, fields,
    bnd_values)``) projected from the linearization primal."""
    from torch.func import jvp, vmap

    asm = eq.asm
    mesh = asm.mesh
    if asm.ndofs != 3:
        raise NotImplementedError("analytic SWE blocks support P1DG cells")
    nc = mesh.nc
    nq = asm.space.phi.shape[0]
    uv_lag = u_lag["uv"]
    dtype = uv_lag.dtype

    # base context at the linearization state (implicit == lagged slots)
    c0 = eq.build_context(u_lag, u_lag, fields, bnd_values)
    c0["_uv_dofs"] = uv_lag
    c0["_uv_old_dofs"] = uv_lag
    c0["_eta_old_dofs"] = u_lag["elev"]
    vals0 = (
        c0["uv_q"], c0["eta_q"], asm.cell_grads(uv_lag),
        c0["uv_tr"], c0["eta_tr"], asm.facet_trace_grads(uv_lag),
    )
    nf, _, nqf = vals0[4].shape
    f = _bucket_fn(eq, c0, "all")
    f0 = f(vals0)

    # The Jacobian is block-separable: cell buckets depend only on the
    # cell quad values and facet buckets only on the traces, so the two
    # halves are linearized separately.
    def f_cell(uv_q, eta_q, grad_q):
        return f((uv_q, eta_q, grad_q) + vals0[3:])[:4]

    def f_trace(uv_tr, eta_tr, grad_tr):
        return f(vals0[:3] + (uv_tr, eta_tr, grad_tr))[4:]

    def lin_c(*t):
        return jvp(f_cell, vals0[:3], t)[1]

    def lin_f(*t):
        return jvp(f_trace, vals0[3:], t)[1]

    d_uc, d_ug, d_ec, d_eg = vmap(lin_c)(*_probe_basis_cell(nc, nq, uv_lag))
    d_uf, d_fg, d_ef = vmap(lin_f)(*_probe_basis_trace(nf, nqf, uv_lag))

    # ---- cell part ---------------------------------------------------
    # value rows out: [u, v, eta, du/dx, du/dy, dv/dx, dv/dy, deta/dx,
    # deta/dy]; Jc (nc, nq, 9, 7)
    Jc = torch.stack([
        d_uc[..., 0], d_uc[..., 1], d_ec,
        d_ug[..., 0, 0], d_ug[..., 0, 1], d_ug[..., 1, 0], d_ug[..., 1, 1],
        d_eg[..., 0], d_eg[..., 1],
    ], dim=-1).permute(1, 2, 3, 0)
    gphi = torch.einsum("qdj,cji->cqdi", asm.space.dphi, mesh.Jinv)
    phi = asm.space.phi.expand(nc, nq, 3)
    E7c, Eg2c = _basis_rows(phi, gphi)                   # (nc, nq, 7|2, 9)
    Eout_c = torch.cat([E7c, Eg2c], dim=-2) * asm.wdetJ[..., None, None]
    D = torch.einsum("cqoI,cqoJ->cIJ", Eout_c, Jc @ E7c)  # (nc, 9, 9)

    # ---- facet part --------------------------------------------------
    # out rows [u, v, eta, fgrad(4)]; Jf (nf, so, si, nqf, 7, 7)
    Jf = torch.stack([
        d_uf[..., 0], d_uf[..., 1], d_ef,
        d_fg[..., 0, 0], d_fg[..., 0, 1], d_fg[..., 1, 0], d_fg[..., 1, 1],
    ], dim=0)                                            # (7, 14, nf, 2, nqf)
    Jf = Jf.reshape(7, 2, _NKF, nf, 2, nqf).permute(3, 4, 1, 5, 0, 2)
    E7f, _ = _basis_rows(asm.both_tabs, asm.both_gtabs_c)  # (nf, 2, nqf, 7, 9)
    Eout_f = E7f * asm.wlen[:, None, :, None, None]
    JE = Jf @ E7f[:, None]                               # (nf, so, si, q, 7, 9)
    Bf = torch.einsum("fsqoI,fsuqoJ->fsuIJ", Eout_f, JE)  # (nf, so, si, 9, 9)
    Bflat = Bf.reshape(nf * 4, 81)  # row f*4 + so*2 + si

    # ---- gather facet blocks into ring slots -------------------------
    cf = mesh.cell_facets                                # (nc, 3)
    cs = mesh.cell_sides                                 # (nc, 3)
    is_bnd_f = ~mesh.facet_is_interior                   # (nf,)
    # interior facets: [s,1-s] couples to the neighbour (ring slot l+1);
    # boundary facets: the mirror trace IS the owner's trace -> fold into
    # the diagonal
    diag_acc = D.reshape(nc, 81)
    slots = []
    for l in range(3):
        base = cf[:, l] * 4 + cs[:, l] * 2
        own_l = Bflat[base + cs[:, l]]                   # (nc, 81)
        opp_l = Bflat[base + (1 - cs[:, l])]             # (nc, 81)
        bnd_l = is_bnd_f[cf[:, l]][:, None].to(dtype)
        diag_acc = diag_acc + own_l + opp_l * bnd_l
        slots.append(opp_l * (1.0 - bnd_l))
    J_T = torch.stack([diag_acc] + slots).permute(0, 2, 1).reshape(4, 9, 9, nc)
    A_T = -coeff * J_T
    A_T[0] += swe_mass_blocks(eq, dtype)
    A_T = A_T.contiguous()
    if return_residual:
        return A_T, _project_buckets(eq, f0)
    return A_T
