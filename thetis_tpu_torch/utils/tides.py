r"""Tidal harmonic prediction.

Self-contained replacement for the ``uptide`` package the reference
delegates to (ref ``forcing.py:1035-1037``): constituent angular speeds,
Greenwich equilibrium arguments V0 from the mean astronomical longitudes,
and first-order nodal modulation factors f, u.

The astronomy follows Schureman (1958) / Pugh (1987, Table 4:3): mean
longitudes of the moon (s), sun (h), lunar perigee (p), lunar ascending
node (N) and solar perigee (p1) as polynomials in Julian centuries since
J2000, and the standard first-order nodal corrections

    f(M2) = 1.000 - 0.037 cos N      u(M2) = -2.1 deg sin N
    f(K2) = 1.024 + 0.286 cos N      u(K2) = -17.7 deg sin N
    f(K1) = 1.006 + 0.115 cos N      u(K1) = -8.9 deg sin N
    f(O1) = 1.009 + 0.187 cos N      u(O1) = 10.8 deg sin N

The predicted elevation for constituent k with amplitude A_k and
Greenwich phase lag g_k is

    eta(t) = sum_k f_k A_k cos(omega_k t + V0_k + u_k - g_k).

Copied unchanged from ``thetis_tpu/utils/tides.py`` (numpy only).
"""
import datetime

import numpy as np

from .timezone import datetime_to_epoch, FixedTimeZone

__all__ = ["Tides", "CONSTITUENT_SPEEDS"]

#: angular speeds in degrees per mean solar hour (Schureman Table 2)
CONSTITUENT_SPEEDS = {
    "M2": 28.9841042,
    "S2": 30.0000000,
    "N2": 28.4397295,
    "K2": 30.0821373,
    "K1": 15.0410686,
    "O1": 13.9430356,
    "P1": 14.9589314,
    "Q1": 13.3986609,
    "M4": 57.9682084,
    "MF": 1.0980331,
    "MM": 0.5443747,
}

#: Doodson-style multiples (s, h, p) for the Greenwich equilibrium
#: argument V0 = n_T * (15 t) + a*s + b*h + c*p + const, evaluated at the
#: epoch; tabulated directly as V0(s, h, p) per Schureman's V formulas
_V0_COEFFS = {
    # name: (a_s, a_h, a_p, const_deg) such that
    # V0 = a_s*s + a_h*h + a_p*p + const  (semidiurnals measured with
    # 2*T angle absorbed into omega*t; t measured from 00:00 UTC of the
    # epoch day requires the hour angle below)
    "M2": (-2.0, 2.0, 0.0, 0.0),
    "S2": (0.0, 0.0, 0.0, 0.0),
    "N2": (-3.0, 2.0, 1.0, 0.0),
    "K2": (0.0, 2.0, 0.0, 0.0),
    "K1": (0.0, 1.0, 0.0, 90.0),
    "O1": (-2.0, 1.0, 0.0, -90.0),
    "P1": (0.0, -1.0, 0.0, -90.0),
    "Q1": (-3.0, 1.0, 1.0, -90.0),
    "M4": (-4.0, 4.0, 0.0, 0.0),
    "MF": (2.0, 0.0, 0.0, 0.0),
    "MM": (1.0, 0.0, -1.0, 0.0),
}


def _astronomical_longitudes(epoch_seconds):
    """Mean longitudes (degrees) at the given Unix epoch time
    (Meeus / Schureman polynomials, J2000 reference)."""
    # Julian centuries since J2000.0 (2000-01-01 12:00 UTC = 946728000)
    T = (epoch_seconds - 946728000.0) / (36525.0 * 86400.0)
    s = 218.3164477 + 481267.88123421 * T
    h = 280.4664567 + 36000.7698278 * T
    p = 83.3532465 + 4069.0137287 * T
    N = 125.0445479 - 1934.1362891 * T
    p1 = 282.9373481 + 1.71945766667 * T
    return tuple(x % 360.0 for x in (s, h, p, N, p1))


def nodal_corrections(constituent, N_deg):
    """First-order nodal factor f and angle u (degrees)
    (Pugh 1987, Table 4:3)."""
    N = np.deg2rad(N_deg)
    c, s = np.cos(N), np.sin(N)
    table = {
        "M2": (1.000 - 0.037 * c, -2.1 * s),
        "N2": (1.000 - 0.037 * c, -2.1 * s),
        "S2": (1.0, 0.0),
        "K2": (1.024 + 0.286 * c, -17.7 * s),
        "K1": (1.006 + 0.115 * c, -8.9 * s),
        "O1": (1.009 + 0.187 * c, 10.8 * s),
        "Q1": (1.009 + 0.187 * c, 10.8 * s),
        "P1": (1.0, 0.0),
        "M4": ((1.000 - 0.037 * c) ** 2, -4.2 * s),
        "MF": (1.043 + 0.414 * c, -23.7 * s),
        "MM": (1.0 - 0.130 * c, 0.0),
    }
    return table[constituent]


class Tides:
    """Harmonic tidal signal from constituent amplitudes/phases
    (the ``uptide.Tides`` analogue)."""

    def __init__(self, constituents):
        self.constituents = [c.upper() for c in constituents]
        for c in self.constituents:
            assert c in CONSTITUENT_SPEEDS, f"unknown constituent {c}"
        self.speeds_deg_hr = np.asarray(
            [CONSTITUENT_SPEEDS[c] for c in self.constituents]
        )
        #: angular frequency in rad/s
        self.omega = np.deg2rad(self.speeds_deg_hr) / 3600.0
        self._init_epoch = None

    def set_initial_time(self, init_date):
        """:arg init_date: timezone-aware datetime of simulation t=0."""
        assert init_date.tzinfo is not None, \
            "init_date must have time zone information"
        self._init_epoch = datetime_to_epoch(init_date)
        s, h, p, N, p1 = _astronomical_longitudes(self._init_epoch)
        # hour angle of the mean sun at the epoch (degrees)
        day = datetime.datetime(
            init_date.year, init_date.month, init_date.day,
            tzinfo=FixedTimeZone(0, "UTC"),
        )
        hours_ut = (self._init_epoch - datetime_to_epoch(day)) / 3600.0
        self.V0 = np.empty(len(self.constituents))
        self.f = np.empty(len(self.constituents))
        self.u = np.empty(len(self.constituents))
        for i, cname in enumerate(self.constituents):
            a_s, a_h, a_p, const = _V0_COEFFS[cname]
            v0 = (CONSTITUENT_SPEEDS[cname] * hours_ut
                  + a_s * s + a_h * h + a_p * p + const)
            f, u = nodal_corrections(cname, N)
            self.V0[i] = v0 % 360.0
            self.f[i] = f
            self.u[i] = u

    def from_amplitude_phase(self, amplitudes, phases, t):
        """eta(t) = sum_k f_k A_k cos(omega_k t + V0_k + u_k - g_k);
        phases g in radians (Greenwich epoch), t in seconds since
        init_date; amplitudes/phases (..., n_constituents)."""
        assert self._init_epoch is not None, "call set_initial_time first"
        A = np.asarray(amplitudes)
        g = np.asarray(phases)
        arg = (self.omega * t + np.deg2rad(self.V0 + self.u)) - g
        return (self.f * A * np.cos(arg)).sum(axis=-1)

    def from_complex(self, h_re, h_im, t):
        """TPXO convention: h = hRe + i hIm with
        eta = Re[h exp(i(omega t + V + u))] * f."""
        assert self._init_epoch is not None, "call set_initial_time first"
        arg = self.omega * t + np.deg2rad(self.V0 + self.u)
        return (self.f * (np.asarray(h_re) * np.cos(arg)
                          - np.asarray(h_im) * np.sin(arg))).sum(axis=-1)
