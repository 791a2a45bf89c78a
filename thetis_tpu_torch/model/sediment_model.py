r"""Sediment transport closure.

Port of ``thetis_tpu/model/sediment_model.py`` (the reference's
``thetis/sediment_model.py``): Shields parameter, settling velocity, skin
friction, van Rijn erosion / deposition fluxes, Meyer-Peter-Mueller
bedload with slope-magnitude and slope-angle corrections, the
advective-velocity correction factor and the sediment-slide diffusion
coefficient, all pointwise functions of the quadrature-point values of
(uv, H, grad zb).  The closure holds no tensor of its own: every result
takes the device and dtype of its inputs.

The Newton products of the port are reverse mode (``solvers/newton.py``),
where ``where(c, f(x), g)`` and ``maximum(f(x), eps)`` send a zero
cotangent into the untaken ``f`` and ``0 * f'(x)`` is NaN where ``f'`` is
infinite (``sqrt`` at 0, ``1/x`` at 0).  Each such ``f`` gets an argument
sanitised by a second ``where`` (:func:`_where_safe`); the values are the
reference's.
"""
import numpy as np
import torch

from ..config import physical_constants
from .options import SedimentModelOptions  # noqa: F401 (re-export)

__all__ = ["SedimentModel", "SedimentModelOptions"]


def _where_safe(cond, fn, x, other, safe=1.0):
    """``where(cond, fn(x), other)`` with ``fn`` evaluated at ``safe``
    where ``cond`` is false, so no infinite derivative of the untaken
    branch meets a zero cotangent."""
    xs = torch.where(cond, x, torch.full_like(x, safe))
    return torch.where(cond, fn(xs), other)


def _sqrt_floor(x, floor):
    """``maximum(sqrt(x), floor)`` for x >= 0 with a finite derivative at
    x = 0 (the square root is taken only where it exceeds the floor)."""
    big = x > floor * floor
    return torch.clamp_min(_where_safe(big, torch.sqrt, x,
                                       torch.zeros_like(x)), floor)


class SedimentModel:
    """Pointwise sediment closure (ref ``sediment_model.py:58-417``)."""

    def __init__(self, options, mesh2d, uv=None, elev=None, depth=None):
        o = options
        so = o.sediment_model_options
        self.options = o
        self.sed_options = so
        self.depth = depth
        self.solve_suspended_sediment = so.solve_suspended_sediment
        self.use_bedload = so.use_bedload
        self.use_angle_correction = so.use_angle_correction
        self.use_slope_mag_correction = so.use_slope_mag_correction
        self.use_advective_velocity_correction = \
            so.use_advective_velocity_correction
        self.use_secondary_current = so.use_secondary_current

        self.g = physical_constants["g_grav"]
        self.rhow = physical_constants["rho0"]
        self.kappa = physical_constants["von_karman"]
        self.rhos = so.sediment_density
        self.average_size = so.average_sediment_size
        self.bed_reference_height = so.bed_reference_height
        self.a = self.bed_reference_height / 2.0
        self.ksp = 3.0 * self.average_size
        visc = (so.morphological_viscosity
                if so.morphological_viscosity is not None
                else (o.horizontal_viscosity or 1e-6))
        self.viscosity = float(visc)
        self.beta = so.slope_effect_parameter
        self.surbeta2 = so.slope_effect_angle_parameter
        self.alpha_secc = so.secondary_current_parameter

        # critical Shields parameter (ref L139-148)
        R = self.rhos / self.rhow - 1.0
        self.R = R
        self.dstar = self.average_size * (
            (self.g * R) / self.viscosity**2) ** (1 / 3)
        if self.dstar < 1:
            raise ValueError("dstar value less than 1")
        d = self.dstar
        if d < 4:
            thetacr = 0.24 / d
        elif d < 10:
            thetacr = 0.14 * d ** (-0.64)
        elif d < 20:
            thetacr = 0.04 * d ** (-0.1)
        elif d < 150:
            thetacr = 0.013 * d**0.29
        else:
            thetacr = 0.055
        self.thetacr = thetacr
        self.taucr = ((self.rhos - self.rhow) * self.g * self.average_size
                      * thetacr)

        # settling velocity (ref L151-155)
        ds = self.average_size
        if ds <= 1e-4:
            self.settling_velocity = (self.g * ds**2 * R
                                      / (18 * self.viscosity))
        elif ds <= 1e-3:
            self.settling_velocity = (10 * self.viscosity / ds) * (
                np.sqrt(1 + 0.01 * R * self.g * ds**3 / self.viscosity**2)
                - 1)
        else:
            self.settling_velocity = 1.1 * np.sqrt(self.g * ds * R)

    # -- pointwise building blocks --------------------------------------
    def _friction(self, H):
        """(qfc, mu): quadratic drag and skin-friction ratio (ref
        L165-174)."""
        hc = torch.clamp_min(H, 0.001)
        aux = torch.clamp_min(11.036 * hc / self.bed_reference_height,
                              1.001)
        qfc = 2.0 / (torch.log(aux) / self.kappa) ** 2
        cfactor = torch.where(
            H > self.ksp,
            2.0 * ((1 / self.kappa) * torch.log(
                11.036 * torch.clamp_min(H, self.ksp) / self.ksp)) ** (-2.0),
            torch.zeros_like(H))
        mu = torch.where(qfc > 0, cfactor / qfc, torch.zeros_like(qfc))
        return qfc, mu

    def _ustar(self, qfc, unorm):
        """``maximum(sqrt(0.5 qfc |u|^2), 1e-12)`` (ref L124-125,
        L152-157)."""
        return _sqrt_floor(0.5 * qfc * unorm, 1e-12)

    def erosion_concentration(self, uv, H):
        """van Rijn reference concentration (ref L194-201)."""
        qfc, mu = self._friction(H)
        unorm = (uv**2).sum(-1)
        stress = self.rhow * 0.5 * qfc * unorm * mu
        tsp = torch.where(stress > 0, (stress - self.taucr) / self.taucr,
                          torch.full_like(stress, -1.0))
        return (0.015 * (self.average_size / self.a)
                * torch.clamp_min(tsp, 0.0) ** 1.5 / self.dstar**0.3)

    def integrated_rouse(self, uv, H):
        """Deposition shape factor (ref L181-192)."""
        qfc, _ = self._friction(H)
        unorm = (uv**2).sum(-1)
        B = torch.where(self.a > H, torch.ones_like(H),
                        self.a / torch.clamp_min(H, 1e-12))
        rouse = (self.settling_velocity / (self.kappa
                                           * self._ustar(qfc, unorm)) - 1.0)
        rmin = torch.clamp_max(rouse, 3.0)
        Bs = torch.clamp(B, 1e-12, 1.0)
        step = torch.where(
            torch.abs(rouse) > 1e-4,
            Bs * (1.0 - Bs ** rmin) / torch.where(
                torch.abs(rmin) > 1e-8, rmin, torch.ones_like(rmin)),
            -Bs * torch.log(Bs))
        inv = _where_safe(step > 1e-12, torch.reciprocal, step,
                          torch.full_like(step, 1e12))
        return torch.clamp_min(inv, 1.0)

    # -- public API (ref L356-385) --------------------------------------
    def get_erosion_term(self, uv, H):
        return self.settling_velocity * self.erosion_concentration(uv, H)

    def get_deposition_coefficient(self, uv, H):
        return self.settling_velocity * self.integrated_rouse(uv, H)

    def get_equilibrium_tracer(self, uv, H):
        return self.erosion_concentration(uv, H) / self.integrated_rouse(uv,
                                                                         H)

    def get_advective_velocity_correction_factor(self, uv, H):
        """ref ``CorrectiveVelocityFactor`` (L5-55)."""
        if not self.use_advective_velocity_correction:
            return 1.0
        kappa = self.kappa
        qfc, _ = self._friction(H)
        unorm = (uv**2).sum(-1)
        ustar = self._ustar(qfc, unorm)
        Bconv = _where_safe(H > 1.1 * self.ksp, lambda h: self.ksp / h, H,
                            torch.full_like(H, 1 / 1.1))
        Aconv = _where_safe(H > 1.1 * self.a, lambda h: self.a / h, H,
                            torch.full_like(H, 1 / 1.1))
        Amax = torch.maximum(Aconv, Bconv)
        r1 = 1.0 - (1 / kappa) * torch.clamp_max(
            self.settling_velocity / ustar, 1.0)
        lnA = torch.log(Amax)
        big = torch.abs(r1) > 1e-8
        r1_safe = torch.where(big, r1, torch.ones_like(r1))
        Ione = torch.where(big, (1.0 - Amax**r1) / r1_safe, lnA)
        Itwo = torch.where(big, -(Ione + lnA * Amax**r1) / r1_safe,
                           -0.5 * lnA**2)
        alpha = -(Itwo - (lnA - np.log(30.0)) * Ione) / (
            Ione * ((lnA - np.log(30.0)) + 1.0))
        return torch.clamp(alpha, 0.0, 1.0)

    def get_bedload_term(self, uv, H, grad_zb_old, grad_zb):
        """Meyer-Peter-Mueller bedload flux (qbx, qby) at quad points
        (ref L222-310).

        :arg grad_zb_old: lagged bed gradient (..., 2)
        :arg grad_zb: current (possibly implicit) bed gradient
        """
        qfc, mu = self._friction(H)
        unorm = (uv**2).sum(-1)
        umag = torch.sqrt(torch.clamp_min(unorm, 1e-14))
        calfa = uv[..., 0] / umag
        salfa = uv[..., 1] / umag

        if self.use_slope_mag_correction:
            slopecoef = 1.0 + self.beta * (
                grad_zb[..., 0] * calfa + grad_zb[..., 1] * salfa)
        else:
            slopecoef = 1.0

        if self.use_angle_correction:
            stress = self.rhow * 0.5 * qfc * unorm
            cparam = ((self.rhos - self.rhow) * self.g * self.average_size
                      * self.surbeta2**2)
            tt1 = torch.sqrt(cparam / torch.clamp_min(stress, 1e-10))
            aa = salfa + tt1 * grad_zb_old[..., 1]
            bb = calfa + tt1 * grad_zb_old[..., 0]
            angle_norm = _sqrt_floor(aa**2 + bb**2, 1e-10)
            calfamod = (calfa + tt1 * grad_zb[..., 0]) / angle_norm
            salfamod = (salfa + tt1 * grad_zb[..., 1]) / angle_norm

        thetaprime = (mu * (self.rhow * 0.5 * qfc * unorm)
                      / ((self.rhos - self.rhow) * self.g
                         * self.average_size))
        phi = torch.where(
            thetaprime < self.thetacr, torch.zeros_like(thetaprime),
            8.0 * torch.clamp_min(thetaprime - self.thetacr, 0.0) ** 1.5)
        qb_total = slopecoef * phi * np.sqrt(
            self.g * self.R * self.average_size**3)
        if self.use_angle_correction:
            return qb_total * calfamod, qb_total * salfamod
        return qb_total * calfa, qb_total * salfa

    def get_sediment_slide_term(self, grad_zb, slide_region_q=None):
        """Sediment-slide diffusion coefficient ``alphaconst`` (the
        isotropic tensor's diagonal) at quadrature points (ref
        ``sediment_model.py:312-354``): where the local bed slope angle
        exceeds ``max_angle`` an artificial bed diffusion relaxes the slope
        back to the angle of repose over ``sed_slide_length_scale``.

        :arg grad_zb: bed gradient (nc, nq, 2) at quad points
        :arg slide_region_q: optional (nc, nq) mask restricting the
            mechanism to a region (the ``slide_region`` option)
        :returns: (nc, nq) non-positive coefficient (enters the Exner
            residual as ``alphaconst * grad(zb) . grad(test)``)
        """
        so = self.sed_options
        tanphi = np.tan(float(so.max_angle) * np.pi / 180.0)
        L = float(so.sed_slide_length_scale)
        morfac = float(so.morphological_acceleration_factor)
        dt = float(self.options.timestep)
        dz = grad_zb
        if slide_region_q is not None:
            dz = slide_region_q[..., None] * dz
        mag2 = (dz**2).sum(-1)
        nz = 1.0 / torch.sqrt(1.0 + mag2)
        s2 = torch.clamp_min(1.0 - nz**2, 0.0)
        sinbeta = _where_safe(s2 > 0.0, torch.sqrt, s2, torch.zeros_like(s2))
        tanbeta = sinbeta / nz
        betaangle = torch.arcsin(torch.clamp(sinbeta, 0.0, 1.0))
        qaval = torch.where(
            tanbeta - tanphi > 0.0,
            (1.0 - float(so.porosity)) * 0.5 * L**2 * (tanbeta - tanphi)
            / torch.cos(betaangle * dt * morfac),
            torch.zeros_like(tanbeta))
        return torch.where(
            sinbeta > 0.0,
            -qaval * nz**2 / torch.clamp_min(sinbeta, 1e-14),
            torch.zeros_like(sinbeta))

    def update(self):
        """No-op: the expressions are evaluated at every residual call
        (the reference's API, ``sediment_model.py:387``)."""
