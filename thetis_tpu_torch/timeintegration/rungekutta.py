"""Runge-Kutta schemes from Butcher tableaux.

Mirrors the reference's tableau registry (``thetis/rungekutta.py:142-408``)
including each scheme's CFL coefficient; the steppers that advance
equation objects with these tableaux are ``steppers.py::ERKGeneric``,
``DIRKGeneric`` and ``DIRKUForm`` and the IMEX pairs of
``implicitexplicit.py``.

The code below this docstring is copied unchanged from
``thetis_tpu/timeintegration/rungekutta.py`` (numpy only).
"""
import numpy as np

__all__ = [
    "SCHEMES",
    "AbstractRKScheme",
    "butcher_to_shuosher_form",
]

CFL_UNCONDITIONALLY_STABLE = np.inf


class AbstractRKScheme:
    """Butcher tableau container (ref ``rungekutta.py:90-139``)."""

    a = None
    b = None
    c = None
    cfl_coeff = None

    def __init__(self):
        self.a = np.array(self.a, dtype=np.float64)
        self.b = np.array(self.b, dtype=np.float64)
        self.c = np.array(self.c, dtype=np.float64)
        assert np.allclose(np.sum(self.a, axis=1), self.c), "inconsistent tableau"
        self.n_stages = len(self.b)
        self.is_implicit = np.diag(self.a).any() or np.triu(self.a, 1).any()
        self.is_dirk = bool(np.diag(self.a).all()) and not np.triu(self.a, 1).any()


class ForwardEulerAbstract(AbstractRKScheme):
    a = [[0.0]]
    b = [1.0]
    c = [0.0]
    cfl_coeff = 1.0


class BackwardEulerAbstract(AbstractRKScheme):
    a = [[1.0]]
    b = [1.0]
    c = [1.0]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class ImplicitMidpointAbstract(AbstractRKScheme):
    a = [[0.5]]
    b = [1.0]
    c = [0.5]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class CrankNicolsonAbstract(AbstractRKScheme):
    a = [[0.0, 0.0], [0.5, 0.5]]
    b = [0.5, 0.5]
    c = [0.0, 1.0]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class SSPRK33Abstract(AbstractRKScheme):
    r"""3rd order, 3-stage SSP RK (Shu-Osher), CFL 1.0
    (ref ``rungekutta.py:955``)."""
    a = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.25, 0.25, 0.0]]
    b = [1.0 / 6.0, 1.0 / 6.0, 2.0 / 3.0]
    c = [0.0, 1.0, 0.5]
    cfl_coeff = 1.0


class ERKMidpointAbstract(AbstractRKScheme):
    a = [[0.0, 0.0], [0.5, 0.0]]
    b = [0.0, 1.0]
    c = [0.0, 0.5]
    cfl_coeff = 1.0


class DIRK22Abstract(AbstractRKScheme):
    r"""2-stage, 2nd order, L-stable DIRK (Ascher et al. 1997;
    ref ``rungekutta.py:218-246``)."""
    gamma = (2.0 - np.sqrt(2.0)) / 2.0
    a = [[gamma, 0], [1 - gamma, gamma]]
    b = [1 - gamma, gamma]
    c = [gamma, 1]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class DIRK33Abstract(AbstractRKScheme):
    r"""3-stage, 3rd order, L-stable DIRK (ref ``rungekutta.py:249-274``)."""
    gamma = 0.4358665215
    b1 = -3.0 / 2.0 * gamma**2 + 4 * gamma - 1.0 / 4.0
    b2 = 3.0 / 2.0 * gamma**2 - 5 * gamma + 5.0 / 4.0
    a = [
        [gamma, 0, 0],
        [(1 - gamma) / 2, gamma, 0],
        [b1, b2, gamma],
    ]
    b = [b1, b2, gamma]
    c = [gamma, (1 + gamma) / 2, 1]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class DIRK43Abstract(AbstractRKScheme):
    r"""4-stage, 3rd order, L-stable DIRK (ref ``rungekutta.py:277-306``)."""
    a = [
        [0.5, 0, 0, 0],
        [1.0 / 6.0, 0.5, 0, 0],
        [-0.5, 0.5, 0.5, 0],
        [3.0 / 2.0, -3.0 / 2.0, 0.5, 0.5],
    ]
    b = [3.0 / 2.0, -3.0 / 2.0, 0.5, 0.5]
    c = [0.5, 2.0 / 3.0, 0.5, 1.0]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class DIRK23Abstract(AbstractRKScheme):
    r"""2-stage, 3rd order DIRK, gamma = (3+sqrt(3))/6; A-stable, not
    L-stable.  DIRK(2,3,3) of Ascher et al. (1997)
    (ref ``rungekutta.py:222-249``)."""
    gamma = (3.0 + np.sqrt(3.0)) / 6.0
    a = [[gamma, 0], [1 - 2 * gamma, gamma]]
    b = [0.5, 0.5]
    c = [gamma, 1 - gamma]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


class DIRKLSPUM2Abstract(AbstractRKScheme):
    r"""DIRKLSPUM2: 3-stage, 2nd order, L-stable SSP DIRK; implicit part
    of IMEX scheme (17) in Higueras et al. (2014)
    (ref ``rungekutta.py:292-310``)."""
    a = [
        [2.0 / 11.0, 0, 0],
        [205.0 / 462.0, 2.0 / 11.0, 0],
        [2033.0 / 4620.0, 21.0 / 110.0, 2.0 / 11.0],
    ]
    b = [24.0 / 55.0, 1.0 / 5.0, 4.0 / 11.0]
    c = [2.0 / 11.0, 289.0 / 462.0, 751.0 / 924.0]
    cfl_coeff = 4.34  # linear problems; nonlinear => 3.82


class DIRKLPUM2Abstract(AbstractRKScheme):
    r"""DIRKLPUM2: 3-stage, 2nd order, L-stable SSP DIRK; implicit part
    of IMEX scheme (20) in Higueras et al. (2014)
    (ref ``rungekutta.py:313-331``)."""
    a = [
        [2.0 / 11.0, 0, 0],
        [41.0 / 154.0, 2.0 / 11.0, 0],
        [289.0 / 847.0, 42.0 / 121.0, 2.0 / 11.0],
    ]
    b = [1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0]
    c = [2.0 / 11.0, 69.0 / 154.0, 67.0 / 77.0]
    cfl_coeff = 4.34  # linear problems; nonlinear => 3.09


class ERKLSPUM2Abstract(AbstractRKScheme):
    r"""ERKLSPUM2: explicit part of IMEX scheme (17) in Higueras et al.
    (2014) (ref ``rungekutta.py:355-371``)."""
    a = [[0, 0, 0], [5.0 / 6.0, 0, 0], [11.0 / 24.0, 11.0 / 24.0, 0]]
    b = [24.0 / 55.0, 1.0 / 5.0, 4.0 / 11.0]
    c = [0, 5.0 / 6.0, 11.0 / 12.0]
    cfl_coeff = 1.2


class ERKLPUM2Abstract(AbstractRKScheme):
    r"""ERKLPUM2: explicit part of IMEX scheme (20) in Higueras et al.
    (2014) (ref ``rungekutta.py:374-390``)."""
    a = [[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0]]
    b = [1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0]
    c = [0, 0.5, 1.0]
    cfl_coeff = 2.0


class ESDIRKMidpointAbstract(AbstractRKScheme):
    r"""Explicit-first-stage singly-diagonal implicit midpoint
    (ref ``rungekutta.py:400-405``)."""
    a = [[0.0, 0.0], [0.0, 0.5]]
    b = [0.0, 1.0]
    c = [0.0, 0.5]
    cfl_coeff = 1.0


class ESDIRKTrapezoidAbstract(AbstractRKScheme):
    r"""Explicit-first-stage trapezoid rule (the 2D mode integrator of
    ``CoupledTwoStageRK``; ref ``rungekutta.py:408-413``)."""
    a = [[0.0, 0.0], [0.5, 0.5]]
    b = [0.5, 0.5]
    c = [0.0, 1.0]
    cfl_coeff = CFL_UNCONDITIONALLY_STABLE


SCHEMES = {
    "ForwardEuler": ForwardEulerAbstract,
    "BackwardEuler": BackwardEulerAbstract,
    "ImplicitMidpoint": ImplicitMidpointAbstract,
    "CrankNicolsonRK": CrankNicolsonAbstract,
    "SSPRK33": SSPRK33Abstract,
    "ERKMidpoint": ERKMidpointAbstract,
    "ERKLSPUM2": ERKLSPUM2Abstract,
    "ERKLPUM2": ERKLPUM2Abstract,
    "DIRK22": DIRK22Abstract,
    "DIRK23": DIRK23Abstract,
    "DIRK33": DIRK33Abstract,
    "DIRK43": DIRK43Abstract,
    "DIRKLSPUM2": DIRKLSPUM2Abstract,
    "DIRKLPUM2": DIRKLPUM2Abstract,
    "ESDIRKMidpoint": ESDIRKMidpointAbstract,
    "ESDIRKTrapezoid": ESDIRKTrapezoidAbstract,
}


def butcher_to_shuosher_form(a, b):
    r"""Convert a Butcher tableau to Shu-Osher form (alpha, beta)
    (ref ``rungekutta.py:13-87``; Ketcheson et al. 2009,
    doi:10.1016/j.apnum.2008.03.034):

        u^(i) = sum_j alpha[i,j] u^(j) + sum_j beta[i,j] F(u^(j))

    with the (non-unique) choice that beta carries the diagonal of the
    concatenated tableau for DIRK schemes and the sub-diagonal for
    explicit schemes.  Returns (s+1, s+1) arrays.
    """
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    n = a.shape[0]
    stacked = np.vstack((a, b))
    implicit = bool(np.diag(a).any())
    iden = np.eye(n)
    alpha = np.zeros((n + 1, n + 1))
    beta = np.zeros((n + 1, n + 1))
    if implicit:
        d = np.diag(np.diag(a))
        al_top = iden - d @ np.linalg.inv(a)
        b_last = np.zeros_like(b)
        b_last[-1] = b[-1]
        al_bot = (b - b_last) @ np.linalg.inv(d) @ (iden - al_top)
        alpha[:, 1:] = np.vstack((al_top, al_bot))
        beta[:, 1:] = np.vstack((d, b_last[None, :]
                                 if b_last.ndim == 1 else b_last))
    else:
        lower = stacked[1:, :]
        d = np.diag(np.diag(lower))
        alpha[1:, 1:] = iden - d @ np.linalg.inv(lower)
        beta[1:, :-1] = d
    # consistency: rows of alpha sum to one
    alpha[:, 0] = 1.0 - alpha.sum(axis=1)
    alpha[np.abs(alpha) < 1e-13] = 0.0
    beta[np.abs(beta) < 1e-13] = 0.0
    assert np.allclose(alpha.sum(axis=1), 1.0)
    cols = slice(1, None) if implicit else slice(None, -1)
    assert np.allclose(beta[:, cols], stacked - alpha[:, cols] @ a)
    return alpha, beta
