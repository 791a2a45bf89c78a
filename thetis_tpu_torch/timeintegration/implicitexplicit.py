r"""IMEX time integrators (port of
``thetis_tpu/timeintegration/implicitexplicit.py``).

An :class:`IMEXGeneric` stepper pairs a DIRK scheme, applied to the terms
labelled 'implicit' and 'nonlinear', with an ERK scheme, applied to the
'explicit' and 'source' terms, interleaving the stage updates (ref
``thetis/implicitexplicit.py:81-108``).  Registered pairs:
:class:`IMEXLPUM2` ('SSPIMEX' in the option vocabulary),
:class:`IMEXLSPUM2`, :class:`IMEXEuler` and :class:`IMEXMidpoint`.
"""
import numpy as np

from ..solvers.newton import NewtonParameters, newton_solve
from .rungekutta import SCHEMES
from .steppers import (TimeIntegrator, _add_stats, _semi_implicit_params,
                       _tree_lc, _zeros_like)

__all__ = ["IMEXGeneric", "IMEXLPUM2", "IMEXLSPUM2", "IMEXMidpoint",
           "IMEXEuler", "get_imex_stepper"]

EXPLICIT_LABELS = frozenset(["explicit", "source"])
IMPLICIT_LABELS = frozenset(["implicit", "nonlinear"])


class IMEXGeneric(TimeIntegrator):
    """ref ``implicitexplicit.py:8-110``; subclasses give the tableau
    pair."""

    dirk_a = None
    dirk_b = None
    erk_a = None
    erk_b = None
    cfl_coeff = None

    def __init__(self, equation, dt, options=None, solver_parameters=None,
                 semi_implicit=False):
        super().__init__(equation, dt, options)
        self.a_im = np.asarray(self.dirk_a, dtype=float)
        self.b_im = np.asarray(self.dirk_b, dtype=float)
        self.a_ex = np.asarray(self.erk_a, dtype=float)
        self.b_ex = np.asarray(self.erk_b, dtype=float)
        self.n_stages = len(self.b_im)
        self.semi_implicit = semi_implicit
        self.params = solver_parameters or NewtonParameters()
        if semi_implicit:
            _semi_implicit_params(self.params)
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values):
        eq = self.equation
        dt = self.dt
        self.stats = stats = {}
        k_im = []
        k_ex = []
        for i in range(self.n_stages):
            terms = [(1.0, solution)]
            terms += [(dt * self.a_ex[i][j], k_ex[j]) for j in range(i)
                      if self.a_ex[i][j] != 0.0]
            terms += [(dt * self.a_im[i][j], k_im[j]) for j in range(i)
                      if self.a_im[i][j] != 0.0]
            base = _tree_lc(terms)
            aii = float(self.a_im[i][i])

            def F(k, base=base, aii=aii):
                u = _tree_lc([(1.0, base), (dt * aii, k)])
                u_nl = base if self.semi_implicit else u
                r = eq.residual(IMPLICIT_LABELS, u, u_nl, fields, fields,
                                bnd_values)
                return _tree_lc([(1.0, eq.mass_term(k)), (-1.0, r)])

            k0 = k_im[-1] if k_im else _zeros_like(solution)
            st = {}
            ki = newton_solve(F, k0, precond=eq.mass_inverse,
                              params=self.params, stats=st)
            _add_stats(stats, st)
            k_im.append(ki)
            u_i = _tree_lc([(1.0, base), (dt * aii, ki)])
            r_ex = eq.residual(EXPLICIT_LABELS, u_i, u_i, fields, fields,
                               bnd_values)
            k_ex.append(eq.mass_inverse(r_ex))
        out = [(1.0, solution)]
        out += [(dt * float(b), k) for b, k in zip(self.b_im, k_im)
                if b != 0.0]
        out += [(dt * float(b), k) for b, k in zip(self.b_ex, k_ex)
                if b != 0.0]
        return _tree_lc(out)


class IMEXLPUM2(IMEXGeneric):
    """SSP-IMEX scheme (20) of Higueras et al. (2014): DIRKLPUM2 +
    ERKLPUM2 (ref ``implicitexplicit.py:120-131``); 'SSPIMEX' in the
    option vocabulary; CFL 2."""

    dirk_a = SCHEMES["DIRKLPUM2"].a
    dirk_b = SCHEMES["DIRKLPUM2"].b
    erk_a = SCHEMES["ERKLPUM2"].a
    erk_b = SCHEMES["ERKLPUM2"].b
    cfl_coeff = 2.0


class IMEXLSPUM2(IMEXGeneric):
    """SSP-IMEX scheme (17) of Higueras et al. (2014): DIRKLSPUM2 +
    ERKLSPUM2 (ref ``implicitexplicit.py:134-145``); CFL 2."""

    dirk_a = SCHEMES["DIRKLSPUM2"].a
    dirk_b = SCHEMES["DIRKLSPUM2"].b
    erk_a = SCHEMES["ERKLSPUM2"].a
    erk_b = SCHEMES["ERKLSPUM2"].b
    cfl_coeff = 2.0


class IMEXMidpoint(IMEXGeneric):
    """Implicit-explicit midpoint (1,2,2) of Ascher et al. (1997):
    ESDIRKMidpoint + ERKMidpoint (ref ``implicitexplicit.py:148-157``)."""

    dirk_a = SCHEMES["ESDIRKMidpoint"].a
    dirk_b = SCHEMES["ESDIRKMidpoint"].b
    erk_a = SCHEMES["ERKMidpoint"].a
    erk_b = SCHEMES["ERKMidpoint"].b
    cfl_coeff = 1.0


class IMEXEuler(IMEXGeneric):
    """Forward-backward Euler pair (ref ``implicitexplicit.py:160-165``)."""

    dirk_a = [[1.0]]
    dirk_b = [1.0]
    erk_a = [[0.0]]
    erk_b = [1.0]
    cfl_coeff = 1.0


def get_imex_stepper(name, equation, dt, options=None, **kw):
    table = {"SSPIMEX": IMEXLPUM2, "IMEXLPUM2": IMEXLPUM2,
             "IMEXLSPUM2": IMEXLSPUM2, "IMEXMidpoint": IMEXMidpoint,
             "IMEXEuler": IMEXEuler}
    return table[name](equation, dt, options, **kw)
