r"""Generic Length Scale (GLS) turbulence closure.

Port of ``thetis_tpu/equations/turbulence.py``: the two-equation k-psi
closure with

  psi = (cmu0)^p k^m l^n        (Umlauf & Burchard 2003)

covering k-epsilon (p=3, m=1.5, n=-1), k-omega (p=-1, m=0.5, n=-1) and the
generic model through the (p, m, n) exponents, with stability functions
(``stability_functions``), Galperin limiters, Patankar-type
positivity-preserving source treatment and implicit vertical-diffusion
column solves (:func:`vdiff_implicit`: one batched tridiagonal solve,
``kernels/tridiag.py``, the CUDA kernel on the card).  The 3D step runs
that solve for both velocity components
(``momentum_3d.vertical_viscosity_implicit``), for every tracer, and twice
in :meth:`GenericLengthScaleModel.step_columns` (k and psi).

The model state lives on the dense 3D column tensors (nc, 3, nz, 2).
Every function takes and returns tensors on the inputs' device and dtype,
reads no device value on the host and writes into no tensor it was given.

``PacanowskiPhilanderModel`` is the algebraic Richardson-number
alternative.
"""
import math

import torch

from ..kernels.tridiag import tridiag_solve
from ..utils.log import print_output
from .eos import as_tensor_like
from .stability_functions import STABILITY_FUNCTIONS

__all__ = ["vdiff_implicit", "GLSModelOptions", "GenericLengthScaleModel",
           "PacanowskiPhilanderModel"]


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


class GLSModelOptions:
    """Defaults mirror the reference's ``GLSModelOptions``."""

    def __init__(self, closure_name="k-epsilon",
                 stability_function_name="Canuto A", **kw):
        self.closure_name = closure_name
        self.stability_function_name = stability_function_name
        self.p, self.m, self.n = 3.0, 1.5, -1.0
        self.schmidt_nb_tke = 1.0
        self.schmidt_nb_psi = 1.3
        self.cmu0 = 0.5477
        self.compute_cmu0 = True
        self.c1 = 1.44
        self.c2 = 1.92
        self.c3_minus = -0.52
        self.c3_plus = 1.0
        self.compute_c3_minus = True
        self.f_wall = 1.0
        self.ri_st = 0.25
        self.kappa = 0.4
        self.compute_kappa = False
        self.compute_schmidt_nb_psi = True
        self.k_min = 1.0e-6
        self.psi_min = 1.0e-14
        self.eps_min = 1.0e-14
        self.len_min = 1.0e-12
        self.visc_min = 1.0e-8
        self.diff_min = 1.0e-8
        self.galperin_clim = 0.30
        self.compute_galperin_clim = True
        self.limit_len = False
        self.limit_psi = True
        if closure_name == "k-omega":
            self.p, self.m, self.n = -1.0, 0.5, -1.0
            self.c1, self.c2 = 0.555, 0.833
        elif closure_name == "Generic Length Scale":
            self.p, self.m, self.n = 2.0, 1.0, -0.67
            self.c1, self.c2 = 1.0, 1.22
            self.schmidt_nb_tke, self.schmidt_nb_psi = 0.8, 1.07
        for k_, v in kw.items():
            setattr(self, k_, v)


class GenericLengthScaleModel:
    """The closure on column tensors; the constructor derives the options
    that are marked ``compute_*`` from the stability functions (Python
    floats, on the host)."""

    def __init__(self, asm3d, options=None):
        self.asm3d = asm3d
        o = options or GLSModelOptions()
        self.options = o
        sf_cls = STABILITY_FUNCTIONS[o.stability_function_name]
        self.stability_functions = sf = sf_cls()
        if o.compute_cmu0:
            o.cmu0 = float(sf.compute_cmu0())
        if o.compute_c3_minus:
            o.c3_minus = float(sf.compute_c3_minus(o.c1, o.c2, o.ri_st))
        if o.compute_kappa:
            o.kappa = float(sf.compute_kappa(o.schmidt_nb_psi, o.cmu0, o.n,
                                             o.c1, o.c2))
        elif o.compute_schmidt_nb_psi:
            o.schmidt_nb_psi = float(
                sf.compute_sigma_psi(o.kappa, o.cmu0, o.n, o.c1, o.c2))
        if o.compute_galperin_clim:
            o.galperin_clim = float(sf.compute_length_clim(o.cmu0, o.ri_st))
        print_output(
            f"GLS closure: {o.closure_name} / {sf.name}: "
            f"cmu0={o.cmu0:.4f} c3_minus={o.c3_minus:.4f} "
            f"sigma_psi={o.schmidt_nb_psi:.4f} clim={o.galperin_clim:.4f}")

    # -- diagnostics -----------------------------------------------------
    def psi_from_k_eps(self, k, eps):
        o = self.options
        l = self.length_from_k_eps(k, eps)
        return o.cmu0**o.p * k**o.m * l**o.n

    def length_from_k_eps(self, k, eps):
        o = self.options
        k, eps = as_tensor_like(k, eps), as_tensor_like(eps, k)
        return torch.clamp_min(
            o.cmu0**3 * k**1.5 / torch.clamp_min(eps, o.eps_min), o.len_min)

    def eps_from_k_psi(self, k, psi, buoy2=None):
        """epsilon and the limited length scale from the prognostic pair
        (Galperin limiter included when ``buoy2`` is given)."""
        o = self.options
        k = torch.clamp_min(k, o.k_min)
        psi = torch.clamp_min(psi, o.psi_min)
        # l from psi = cmu0^p k^m l^n
        l = (psi / (o.cmu0**o.p * k**o.m)) ** (1.0 / o.n)
        l = torch.clamp_min(l, o.len_min)
        if buoy2 is not None:
            # Galperin limiter: l <= clim*sqrt(2k/N2) under stratification
            lmax = o.galperin_clim * torch.sqrt(
                2 * k / torch.clamp_min(buoy2, 1e-12))
            l = torch.where(buoy2 > 0, torch.minimum(l, lmax), l)
        eps = torch.clamp_min(o.cmu0**3 * k**1.5 / l, o.eps_min)
        return eps, l

    def compute_shear_buoy_freq(self, uv3d, rho_prime, geom, rho0=1000.0,
                                g=9.81):
        """M^2 and N^2 from vertical gradients, projected onto the dofs."""
        a3 = self.asm3d
        g_uv = a3.cell_grads(uv3d, geom)  # (..., comp, 3)
        m2_q = (g_uv[..., 0, 2] ** 2 + g_uv[..., 1, 2] ** 2)
        m2 = a3.mass_inverse(a3.cell_to_dofs(m2_q, geom), geom)
        if rho_prime is not None:
            g_r = a3.cell_grads(rho_prime, geom)[..., 2]
            n2_q = -g / rho0 * g_r
            n2 = a3.mass_inverse(a3.cell_to_dofs(n2_q, geom), geom)
        else:
            n2 = torch.zeros_like(m2)
        return torch.clamp_min(m2, 1e-12), n2

    def limit_psi(self, k, psi, n2):
        """Galperin limit imposed through psi: for n<0 a *minimum*
        value."""
        o = self.options
        n2_pos = torch.clamp_min(n2, 0.0) + 1e-12
        val = (
            math.sqrt(2.0) * o.galperin_clim * o.cmu0 ** (o.p / o.n)
            * torch.clamp_min(k, o.k_min) ** (o.m / o.n + 0.5)
            * n2_pos ** (-0.5)
        ) ** o.n
        if o.n > 0:
            return torch.minimum(psi, val)
        return torch.maximum(psi, val)

    def eddy_coefficients(self, k, psi, m2, n2):
        """nu = sqrt(k) l S_m / cmu0^3, mu likewise with S_rho (the
        stability functions are in the c_mu convention,
        nu = c_mu k^2/eps)."""
        o = self.options
        k = torch.clamp_min(k, o.k_min)
        if o.limit_psi:
            psi = self.limit_psi(k, psi, n2)
        eps, l = self.eps_from_k_psi(k, psi, n2)
        s_m, s_h = self.stability_functions.evaluate(m2, n2, k, eps)
        b = torch.sqrt(k) * l / o.cmu0**3
        nu = torch.clamp_min(b * s_m, o.visc_min)
        mu = torch.clamp_min(b * s_h, o.diff_min)
        return nu, mu, eps, l

    # -- prognostic update (TKE/Psi equations) ---------------------------
    def step_columns(self, k, psi, m2, n2, nu, mu, Dn, dt):
        """Semi-implicit column update of (k, psi):

        - production P = nu M^2, buoyancy B = -mu N^2, dissipation eps,
          with Patankar treatment of the sinks (sinks divided by the old
          value and treated implicitly),
        - implicit vertical diffusion with nu/sigma Schmidt numbers as a
          batched tridiagonal (Thomas) solve per column node: two launches
          of the tridiagonal kernel, one right-hand side each (k and psi
          diffuse with different coefficients).

        All tensors (nc, 3, nz, 2); Dn (nc, 3, nz) layer thickness.
        """
        o = self.options
        eps, l = self.eps_from_k_psi(k, psi, n2)
        P = nu * m2
        B = -mu * n2
        # --- TKE sources with Patankar splitting ------------------------
        # explicit: P + B^+ ; implicit sink: (eps + B^-) * k_new/k_old
        Bplus = torch.clamp_min(B, 0.0)
        Bminus = torch.clamp_max(B, 0.0)
        k_old = torch.clamp_min(k, o.k_min)
        k_star = (k + dt * (P + Bplus)) / (
            1.0 + dt * (eps - Bminus) / k_old)
        # --- Psi sources ------------------------------------------------
        # (a 0-d tensor of B's dtype: ``where`` of two Python numbers
        # would give the default dtype)
        c3 = torch.where(B > 0, B.new_full((), o.c3_plus), o.c3_minus)
        psi_old = torch.clamp_min(psi, o.psi_min)
        fac = psi_old / k_old
        src_psi = fac * (o.c1 * P + c3 * B)
        sink_psi = fac * o.c2 * eps * o.f_wall
        # (the reference adds ``dt * min(src_psi, 0) * 0.0`` to the
        # numerator: a term that is zero for every finite input, left out)
        psi_star = (psi + dt * torch.clamp_min(src_psi, 0.0)) / (
            1.0 + dt * (sink_psi - torch.clamp_max(src_psi, 0.0)) / psi_old)
        # --- psi wall-flux boundary conditions --------------------------
        # (nu_v/sigma_psi dpsi/dz)|_wall = n nu_v/sigma_psi cmu0^p k^m
        #     kappa^n z_w^(n-1), z_w = 0.5 dz + z0;
        # these anchor l ~ kappa z near the surface/bottom and prevent the
        # neutral-flow length-scale runaway.  kappa and the roughness
        # lengths are the reference's literals, not ``options.kappa`` or
        # the model's ``bottom_roughness``.
        kappa = 0.4
        z0b = 0.005
        z0s = 0.05
        diff_psi = nu / o.schmidt_nb_psi
        dz_bot = Dn[..., 0]
        dz_top = Dn[..., -1]
        z_b = 0.5 * dz_bot + z0b
        z_s = 0.5 * dz_top + z0s
        # inward wall flux magnitude |n| ... : for n<0 the law of the wall
        # has psi increasing toward the wall (l ~ kappa z), so the boundary
        # flux acts as a positive source in the wall cells
        flux_b = (abs(o.n) * diff_psi[..., 0, 0] * o.cmu0**o.p
                  * torch.clamp_min(k[..., 0, 0], o.k_min) ** o.m
                  * kappa**o.n * z_b ** (o.n - 1.0))
        flux_s = (abs(o.n) * diff_psi[..., -1, 1] * o.cmu0**o.p
                  * torch.clamp_min(k[..., -1, 1], o.k_min) ** o.m
                  * kappa**o.n * z_s ** (o.n - 1.0))
        # finite-volume source on the boundary half-cells; ``psi_star`` is
        # a tensor made above, so nothing the caller holds is written
        psi_star[..., 0, 0] += dt * flux_b / torch.clamp_min(0.5 * dz_bot,
                                                             1e-12)
        psi_star[..., -1, 1] += dt * flux_s / torch.clamp_min(0.5 * dz_top,
                                                              1e-12)
        # --- implicit vertical diffusion --------------------------------
        k_new = vdiff_implicit(k_star, nu / o.schmidt_nb_tke, Dn, dt)
        psi_new = vdiff_implicit(psi_star, diff_psi, Dn, dt)
        k_new = torch.clamp_min(k_new, o.k_min)
        psi_new = torch.clamp_min(psi_new, o.psi_min)
        return k_new, psi_new

    @staticmethod
    def _vdiff_implicit(f, nu, Dn, dt):
        return vdiff_implicit(f, nu, Dn, dt)


class PacanowskiPhilanderModel:
    r"""Algebraic Richardson-number closure:
    nu = nu_max / (1 + alpha Ri)^n + visc_min,
    mu = nu / (1 + alpha Ri) + diff_min."""

    def __init__(self, max_viscosity=5e-2, alpha=10.0, exponent=2.0,
                 visc_min=1e-8, diff_min=1e-8):
        self.max_viscosity = max_viscosity
        self.alpha = alpha
        self.exponent = exponent
        self.visc_min = visc_min
        self.diff_min = diff_min

    def eddy_coefficients(self, m2, n2):
        ri = torch.clamp_min(n2 / torch.clamp_min(m2, 1e-12), 0.0)
        denom = (1.0 + self.alpha * ri) ** self.exponent
        nu = self.max_viscosity / denom + self.visc_min
        mu = nu / (1.0 + self.alpha * ri) + self.diff_min
        return nu, mu
