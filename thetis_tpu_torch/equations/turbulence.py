r"""Implicit vertical diffusion of column profiles.

Port of ``GenericLengthScaleModel._vdiff_implicit`` of
``thetis_tpu/equations/turbulence.py`` (ref ``turbulence.py:250-285``):
the backward-Euler vertical diffusion solve that the 3D step runs for
both velocity components (``momentum_3d.vertical_viscosity_implicit``)
and every tracer, each one batched tridiagonal solve
(``kernels/tridiag.py``, the CUDA kernel on the card).

The GLS closure itself (``step_columns``, the stability functions) is not
ported yet (ROADMAP A7): :class:`GenericLengthScaleModel` raises at
construction and only carries the column solve it will call.
"""
import torch

from ..kernels.tridiag import tridiag_solve

__all__ = ["vdiff_implicit", "GenericLengthScaleModel"]


def vdiff_implicit(f, nu, Dn, dt):
    """Backward-Euler vertical diffusion per column, treating each
    column's layer-interface values as a continuous profile
    (finite volumes over layers; one batched Thomas solve).

    :arg f: (..., nc, 3, nz, 2) field (leading axes are batched, e.g. the
        two velocity components)
    :arg nu: (nc, 3, nz, 2) diffusivity
    :arg Dn: (nc, 3, nz) layer thickness at the horizontal nodes
    :arg dt: time step
    """
    # collapse (layer, vnode) to the interface profile of length nz+1
    prof = torch.cat([f[..., :, 0], f[..., -1:, 1]], dim=-1)
    nu_if = torch.cat([nu[..., :, 0], nu[..., -1:, 1]], dim=-1)
    # finite volumes around interfaces: V_0 = Dn_0/2,
    # V_i = (Dn_{i-1}+Dn_i)/2, V_n = Dn_{n-1}/2 — the scheme then exactly
    # conserves the trapezoid column integral
    V = torch.cat([0.5 * Dn[..., :1], 0.5 * (Dn[..., :-1] + Dn[..., 1:]),
                   0.5 * Dn[..., -1:]], dim=-1)
    V = torch.clamp_min(V, 1e-12)
    # flux between interfaces i, i+1: F_i = nu_mid_i (f_{i+1}-f_i)/Dn_i
    nu_mid = 0.5 * (nu_if[..., :-1] + nu_if[..., 1:])
    g = dt * nu_mid / torch.clamp_min(Dn, 1e-12)          # (.., nz)
    zero = torch.zeros_like(g[..., :1])
    a = torch.cat([zero, g], dim=-1) / V
    c = torch.cat([g, zero], dim=-1) / V
    b = 1.0 + a + c
    # system: -a_i f_{i-1} + b_i f_i - c_i f_{i+1} = d_i
    xs = tridiag_solve(-a, b, -c, prof)
    return torch.stack([xs[..., :-1], xs[..., 1:]], dim=-1)


class GenericLengthScaleModel:
    """Placeholder of the GLS closure: only its implicit column solve is
    ported (the 3D step's mixing calls it as
    :meth:`_vdiff_implicit`)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the GLS turbulence closure is not ported to thetis_tpu_torch "
            "yet (ROADMAP A7)")

    @staticmethod
    def _vdiff_implicit(f, nu, Dn, dt):
        return vdiff_implicit(f, nu, Dn, dt)
