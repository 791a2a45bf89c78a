r"""Turbulence closure stability functions.

Port of ``thetis_tpu/equations/stability_functions.py``: the Canuto A/B and
Cheng families (closure constants l1..l8 from Canuto et al. 2001 / Cheng et
al. 2002 as tabulated in Umlauf & Burchard 2005), with the alpha_N /
alpha_M limiters of Umlauf & Burchard (2005) and Burchard & Petersen
(1999), and derived GLS parameters (cmu0, c3_minus, kappa <-> sigma_psi,
Galperin length-scale limit).

``evaluate`` and the limiters it calls take tensors (they run inside the
3D step's turbulence update, on the tensors' own device and dtype);
``eval_funcs`` takes tensors there and Python floats at set-up.  The scalar
parameter computations run on the host at set-up and return Python floats:
a numpy scalar on the left of a tensor would pull the tensor to the host.
"""
import math

import torch

__all__ = [
    "StabilityFunctionCanutoA",
    "StabilityFunctionCanutoB",
    "StabilityFunctionCheng",
    "GOTMStabilityFunctionCanutoA",
    "GOTMStabilityFunctionCanutoB",
    "GOTMStabilityFunctionKanthaClayson",
    "GOTMStabilityFunctionCheng",
    "compute_normalized_frequencies",
    "STABILITY_FUNCTIONS",
]


def _sqrt(x):
    """Square root of a Python float; NaN for a negative one, as numpy
    gives it in the reference (Kantha-Clayson has no steady alpha_M at
    Ri_st = 0.25, so its Galperin factor is NaN there too)."""
    return math.sqrt(x) if x >= 0 else math.nan


def compute_normalized_frequencies(shear2, buoy2, k, eps):
    r"""alpha_M = k^2/eps^2 M^2, alpha_N = k^2/eps^2 N^2
    (Burchard & Bolding 2001; ref L44-67)."""
    alpha_buoy = k**2 / eps**2 * buoy2
    alpha_shear = k**2 / eps**2 * shear2
    return alpha_buoy, alpha_shear


class CanutoStabilityFunctionBase:
    """Original Canuto-form stability functions (ref L430-690)."""

    l1 = l2 = l3 = l4 = l5 = l6 = l7 = l8 = None
    name = None

    def __init__(self, lim_alpha_shear=True, lim_alpha_buoy=True,
                 smooth_alpha_buoy_lim=True, alpha_buoy_crit=-1.2):
        self.lim_alpha_shear = lim_alpha_shear
        self.lim_alpha_buoy = lim_alpha_buoy
        self.smooth_alpha_buoy_lim = smooth_alpha_buoy_lim
        self.alpha_buoy_crit = alpha_buoy_crit
        l1, l2, l3, l4, l5, l6, l7, l8 = (
            self.l1, self.l2, self.l3, self.l4, self.l5, self.l6, self.l7,
            self.l8,
        )
        self.s0 = 1.5 * l1 * l5**2
        self.s1 = (-l4 * (l6 + l7) + 2 * l4 * l5 * (l1 - l2 / 3.0 - l3)
                   + 1.5 * l1 * l5 * l8)
        self.s2 = -3.0 / 8 * l1 * (l6**2 - l7**2)
        self.s4 = 2 * l5
        self.s5 = 2 * l4
        self.s6 = (2.0 / 3 * l5 * (3 * l3**2 - l2**2)
                   - 0.5 * l5 * l1 * (3 * l3 - l2)
                   + 0.75 * l1 * (l6 - l7))
        self.dd0 = 3 * l5**2
        self.dd1 = l5 * (7 * l4 + 3 * l8)
        self.dd2 = l5**2 * (3 * l3**2 - l2**2) - 0.75 * (l6**2 - l7**2)
        self.dd3 = l4 * (4 * l4 + 3 * l8)
        self.dd5 = 0.25 * (l2**2 - 3 * l3**2) * (l6**2 - l7**2)
        self.dd4 = (l4 * (l2 * l6 - 3 * l3 * l7 - l5 * (l2**2 - l3**2))
                    + l5 * l8 * (3 * l3**2 - l2**2))
        # unit conversion to (alpha_M, alpha_N) variables (ref L688-703)
        a = 4.0   # alpha_scalar
        c = 2.0   # cu_scalar
        self.d0 = self.dd0
        self.d1 = a * self.dd1
        self.d2 = a * self.dd2
        self.d3 = a**2 * self.dd4
        self.d4 = a**2 * self.dd3
        self.d5 = a**2 * self.dd5
        self.n0 = c * self.s0
        self.n1 = c * a * self.s1
        self.n2 = c * a * self.s2
        self.nb0 = c * self.s4
        self.nb1 = c * a * self.s5
        self.nb2 = c * a * self.s6

    # -- scalar parameter computations (host side) -----------------------
    def eval_funcs(self, alpha_buoy, alpha_shear):
        """Unlimited S_m, S_rho (Burchard & Petersen 1999 eq 30-31)."""
        den = (self.d0 + self.d1 * alpha_buoy + self.d2 * alpha_shear
               + self.d3 * alpha_buoy * alpha_shear
               + self.d4 * alpha_buoy**2 + self.d5 * alpha_shear**2)
        c_mu = (self.n0 + self.n1 * alpha_buoy + self.n2 * alpha_shear) / den
        c_mu_p = (self.nb0 + self.nb1 * alpha_buoy
                  + self.nb2 * alpha_shear) / den
        return c_mu, c_mu_p

    @staticmethod
    def _quad_root(a, b, c, sign=+1.0):
        """Root of a x^2 + b x + c = 0, degenerating to the linear root
        when a ~ 0 (e.g. Kantha-Clayson, where ab1 = ab2 kills the
        quadratic coefficient)."""
        if abs(a) < 1e-14 * max(abs(b), 1.0):
            return -c / b
        return (-b + sign * _sqrt(b**2 - 4 * a * c)) / 2 / a

    def compute_alpha_shear_steady(self, ri_st):
        """Steady-state alpha_M (Umlauf & Burchard 2005 eq A.19;
        ref L132-168)."""
        a = (-self.d5 + self.n2 - (self.d3 - self.n1 + self.nb2) * ri_st
             - (self.d4 + self.nb1) * ri_st**2)
        b = -self.d2 + self.n0 - (self.d1 + self.nb0) * ri_st
        c = -self.d0
        return self._quad_root(a, b, c, +1.0)

    def compute_c3_minus(self, c1, c2, ri_st):
        """c3_minus from the steady-state Richardson number
        (Burchard & Bolding 2001 eq 32; ref L169-189)."""
        a_shear = self.compute_alpha_shear_steady(ri_st)
        a_buoy = ri_st * a_shear
        s_m, s_h = self.eval_funcs(a_buoy, a_shear)
        return c2 - (c2 - c1) * s_m / s_h / ri_st

    def compute_cmu0(self):
        """cmu0 (Umlauf & Burchard 2005 eq A.22; ref L190-216)."""
        a = self.d5 - self.n2
        b = self.d2 - self.n0
        c = self.d0
        a_shear = self._quad_root(a, b, c, -1.0)
        s_m, _ = self.eval_funcs(0.0, a_shear)
        return s_m**0.25

    def compute_kappa(self, sigma_psi, cmu0, n, c1, c2):
        """Umlauf & Burchard (2003) eq 14 (ref L217-226)."""
        return cmu0 / abs(n) * _sqrt(sigma_psi * (c2 - c1))

    def compute_sigma_psi(self, kappa, cmu0, n, c1, c2):
        return (n * kappa) ** 2 / (cmu0**2 * (c2 - c1))

    def compute_length_clim(self, cmu0, ri_st):
        """Galperin length-scale limit factor (ref L236-247)."""
        a_shear = self.compute_alpha_shear_steady(ri_st)
        a_buoy = ri_st * a_shear
        return cmu0**3.0 * _sqrt(a_buoy / 2)

    def get_alpha_buoy_min(self):
        """Minimum alpha_N (Umlauf & Burchard 2005 Table 3; ref L248-257)."""
        return 0.5 * (
            _sqrt((self.d1 + self.nb0) ** 2
                    - 4.0 * self.d0 * (self.d4 + self.nb1))
            - (self.d1 + self.nb0)
        ) / (self.d4 + self.nb1)

    # -- tensor evaluation (hot loop) -----------------------------------
    def get_alpha_shear_max(self, alpha_buoy):
        """Max alpha_M (Umlauf & Burchard 2005 eq 44; ref L258-275)."""
        n_ = (self.d0 * self.n0
              + (self.d0 * self.n1 + self.d1 * self.n0) * alpha_buoy
              + (self.d1 * self.n1 + self.d4 * self.n0) * alpha_buoy**2
              + self.d4 * self.n1 * alpha_buoy**3)
        d_ = (self.d2 * self.n0
              + (self.d2 * self.n1 + self.d3 * self.n0) * alpha_buoy
              + self.d3 * self.n1 * alpha_buoy**2)
        return n_ / d_

    def get_alpha_buoy_smooth_min(self, alpha_buoy):
        """Smooth limiter (Burchard & Petersen 1999 eq 19; ref L276-284)."""
        return alpha_buoy - (alpha_buoy - self.alpha_buoy_crit) ** 2 / (
            alpha_buoy + self.get_alpha_buoy_min()
            - 2 * self.alpha_buoy_crit
        )

    def evaluate(self, shear2, buoy2, k, eps):
        """Limited (S_m, S_rho) from dimensional variables (ref L335-358);
        tensors in, tensors out, no host value read."""
        alpha_buoy, alpha_shear = compute_normalized_frequencies(
            shear2, buoy2, k, eps
        )
        if self.lim_alpha_buoy:
            if not self.smooth_alpha_buoy_lim:
                alpha_buoy = torch.clamp_min(alpha_buoy,
                                             self.get_alpha_buoy_min())
            else:
                ab_smooth = self.get_alpha_buoy_smooth_min(alpha_buoy)
                alpha_buoy = torch.where(
                    alpha_buoy < self.alpha_buoy_crit, ab_smooth, alpha_buoy
                )
        if self.lim_alpha_shear:
            as_max = self.get_alpha_shear_max(alpha_buoy)
            alpha_shear = torch.minimum(alpha_shear, as_max)
        return self.eval_funcs(alpha_buoy, alpha_shear)


class StabilityFunctionCanutoA(CanutoStabilityFunctionBase):
    """Canuto et al. (2001) version A (ref L697-710)."""

    l1, l2, l3, l4 = 0.107, 0.0032, 0.0864, 0.12
    l5, l6, l7, l8 = 11.9, 0.4, 0.0, 0.48
    name = "Canuto A"


class StabilityFunctionCanutoB(CanutoStabilityFunctionBase):
    """Canuto et al. (2001) version B (ref L712-725)."""

    l1, l2, l3, l4 = 0.127, 0.00336, 0.0906, 0.101
    l5, l6, l7, l8 = 11.2, 0.4, 0.0, 0.318
    name = "Canuto B"


class StabilityFunctionCheng(CanutoStabilityFunctionBase):
    """Cheng et al. (2002) (ref L727-740)."""

    l1, l2, l3, l4 = 0.107, 0.0032, 0.0864, 0.1
    l5, l6, l7, l8 = 11.04, 0.786, 0.643, 0.547
    name = "Cheng"


class GOTMStabilityFunctionBase(CanutoStabilityFunctionBase):
    """GOTM-form stability functions parameterised by the (cc1..cc6,
    cb1..cb5, cbb) closure constants of Umlauf & Burchard (2005) Table 1
    (ref ``stability_functions.py:363-478``).  The d*/n*/nb* polynomial
    coefficients follow U&B (2005) eq A.9-A.12; the evaluation, limiter
    and derived-parameter machinery is shared with the Canuto-form base.
    """

    cc1 = cc2 = cc3 = cc4 = cc5 = cc6 = None
    cb1 = cb2 = cb3 = cb4 = cb5 = cbb = None

    def __init__(self, lim_alpha_shear=True, lim_alpha_buoy=True,
                 smooth_alpha_buoy_lim=True, alpha_buoy_crit=-1.2):
        # intentionally NOT calling the Canuto-form __init__: the
        # polynomial coefficients come from the GOTM constants instead
        self.lim_alpha_shear = lim_alpha_shear
        self.lim_alpha_buoy = lim_alpha_buoy
        self.smooth_alpha_buoy_lim = smooth_alpha_buoy_lim
        self.alpha_buoy_crit = alpha_buoy_crit
        # U&B (2005) eq A.10
        a1 = 2.0 / 3.0 - 0.5 * self.cc2
        a2 = 1.0 - 0.5 * self.cc3
        a3 = 1.0 - 0.5 * self.cc4
        a5 = 0.5 - 0.5 * self.cc6
        ab1 = 1.0 - self.cb2
        ab2 = 1.0 - self.cb3
        ab3 = 2.0 * (1.0 - self.cb4)
        ab4 = 2.0 * (1.0 - self.cb5)
        ab5 = 2.0 * self.cbb * (1.0 - self.cb5)
        del ab4  # enters only through ab5 in this family
        # U&B (2005) eq A.12
        nn = 0.5 * self.cc1
        nb = self.cb1
        # U&B (2005) eq A.9
        self.d0 = 36.0 * nn**3 * nb**2
        self.d1 = (84.0 * a5 * ab3 * nn**2 * nb
                   + 36.0 * ab5 * nn**3 * nb)
        self.d2 = (9.0 * (ab2**2 - ab1**2) * nn**3
                   - 12.0 * (a2**2 - 3.0 * a3**2) * nn * nb**2)
        self.d3 = (12.0 * a5 * ab3 * (a2 * ab1 - 3.0 * a3 * ab2) * nn
                   + 12.0 * a5 * ab3 * (a3**2 - a2**2) * nb
                   + 12.0 * ab5 * (3.0 * a3**2 - a2**2) * nn * nb)
        self.d4 = (48.0 * a5**2 * ab3**2 * nn
                   + 36.0 * a5 * ab3 * ab5 * nn**2)
        self.d5 = (3.0 * (a2**2 - 3.0 * a3**2)
                   * (ab1**2 - ab2**2) * nn)
        self.n0 = 36.0 * a1 * nn**2 * nb**2
        self.n1 = (-12.0 * a5 * ab3 * (ab1 + ab2) * nn**2
                   + 8.0 * a5 * ab3 * (6.0 * a1 - a2 - 3.0 * a3) * nn * nb
                   + 36.0 * a1 * ab5 * nn**2 * nb)
        self.n2 = 9.0 * a1 * (ab2**2 - ab1**2) * nn**2
        self.nb0 = 12.0 * ab3 * nn**3 * nb
        self.nb1 = 12.0 * a5 * ab3**2 * nn**2
        self.nb2 = (9.0 * a1 * ab3 * (ab1 - ab2) * nn**2
                    + (6.0 * a1 * (a2 - 3.0 * a3)
                       - 4.0 * (a2**2 - 3.0 * a3**2)) * ab3 * nn * nb)


class GOTMStabilityFunctionCanutoA(GOTMStabilityFunctionBase):
    """Canuto et al. (2001) version A, GOTM constants
    (U&B 2005 Table 1; ref L742-761)."""

    cc1, cc2, cc3, cc4, cc5, cc6 = 5.0, 0.8, 1.968, 1.136, 0.0, 0.4
    cb1, cb2, cb3, cb4, cb5, cbb = 5.95, 0.6, 1.0, 0.0, 0.3333, 0.72
    name = "Canuto A GOTM"


class GOTMStabilityFunctionCanutoB(GOTMStabilityFunctionBase):
    """Canuto et al. (2001) version B, GOTM constants (ref L763-782)."""

    cc1, cc2, cc3, cc4, cc5, cc6 = 5.0, 0.6983, 1.9664, 1.094, 0.0, 0.495
    cb1, cb2, cb3, cb4, cb5, cbb = 5.6, 0.6, 1.0, 0.0, 0.3333, 0.477
    name = "Canuto B GOTM"


class GOTMStabilityFunctionKanthaClayson(GOTMStabilityFunctionBase):
    """Kantha & Clayson (1994) quasi-equilibrium (ref L784-803)."""

    cc1, cc2, cc3, cc4, cc5, cc6 = 6.0, 0.32, 0.0, 0.0, 0.0, 0.0
    cb1, cb2, cb3, cb4, cb5, cbb = 3.728, 0.7, 0.7, 0.0, 0.2, 0.6102
    name = "Kantha-Clayson"


class GOTMStabilityFunctionCheng(GOTMStabilityFunctionBase):
    """Cheng et al. (2002) quasi-equilibrium (ref L805-822)."""

    cc1, cc2, cc3, cc4, cc5, cc6 = 5.0, 0.7983, 1.968, 1.136, 0.0, 0.5
    cb1, cb2, cb3, cb4, cb5, cbb = 5.52, 0.2134, 0.357, 0.0, 0.3333, 0.82
    name = "Cheng GOTM"


STABILITY_FUNCTIONS = {
    "Canuto A": StabilityFunctionCanutoA,
    "Canuto B": StabilityFunctionCanutoB,
    "Cheng": StabilityFunctionCheng,
    "Canuto A GOTM": GOTMStabilityFunctionCanutoA,
    "Canuto B GOTM": GOTMStabilityFunctionCanutoB,
    "Kantha-Clayson": GOTMStabilityFunctionKanthaClayson,
    "Cheng GOTM": GOTMStabilityFunctionCheng,
}
