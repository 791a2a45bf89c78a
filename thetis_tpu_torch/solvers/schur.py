r"""Matrix-free wave-equation Schur preconditioner (port of
``thetis_tpu/solvers/schur.py``).

The theta-weighted shallow-water wave system

    [ M_u         -theta*dt*G ] [du]   [r_u]
    [ -theta*dt*D   M_eta     ] [de] = [r_e]

(G = d(epg residual)/d(eta), D = d(hudiv residual)/d(uv)) is solved by
block elimination with the elevation Schur complement

    S = M_eta - theta^2 dt^2 D M_u^{-1} G

kept matrix-free and inverted with a fixed-iteration CG preconditioned
by the elevation mass inverse: no host sync per application.  The
tangents of the residual at the linearization state are linearized once,
when the preconditioner is built (the Newton solver's reverse-over-reverse
map: each product is one backward pass of a stored graph), and the mass
inverses are taken a field at a time (``mass_inverse_uv`` /
``mass_inverse_elev``), so no application pays for the other field's
inverse (with a CG elevation that is a 30-iteration PCG).  The
``preconditioner='schur'`` option of the Newton CrankNicolson builds one
per step; PressureProjectionPicard one per Picard sweep on a CG
elevation.
"""
import torch

from .newton import _tangent_map

__all__ = ["WaveEquationSchurPC"]

_EPG = frozenset(["ExternalPressureGradientTerm"])
_HUDIV = frozenset(["HUDivTerm"])


def _tree_axpy(a, x, y):
    return a * x + y


def _dot(x, y):
    return (x * y).sum()


class WaveEquationSchurPC:
    """Build once per (linearisation state, fields) and pass as
    ``precond`` to :func:`~thetis_tpu_torch.solvers.newton.newton_solve`.

    :arg eq: a ShallowWaterEquations-like object exposing
        ``residual/mass_term/mass_inverse_uv/mass_inverse_elev`` and the
        ExternalPressureGradientTerm / HUDivTerm term names
    :arg lin_state: solution dict to linearise about
    :arg inner_iterations: CG iteration count for the S solve
    """

    def __init__(self, eq, dt, theta, lin_state, fields, bnd_values,
                 inner_iterations=15):
        self.eq = eq
        self.coeff = float(theta) * float(dt)
        self.n_inner = int(inner_iterations)
        uv0, eta0 = lin_state["uv"], lin_state["elev"]

        # tangent operators about the (lagged) linearisation state; the
        # affine parts (boundary data) drop out in the tangents
        def epg_of_eta(e):
            return eq.residual(_EPG, {"uv": uv0, "elev": e}, lin_state,
                               fields, fields, bnd_values)["uv"]

        def hudiv_of_uv(u):
            return eq.residual(_HUDIV, {"uv": u, "elev": eta0}, lin_state,
                               fields, fields, bnd_values)["elev"]

        def mass_eta(e):
            return eq.mass_term({"uv": uv0, "elev": e})["elev"]

        def tangent(f, x0):
            jv = _tangent_map(lambda d: {"y": f(d["x"])}, {"x": x0})
            return lambda v: jv({"x": v})["y"]

        self.G = tangent(epg_of_eta, eta0)
        self.D = tangent(hudiv_of_uv, uv0)
        self.Me = tangent(mass_eta, eta0)

    # -- block helpers ---------------------------------------------------
    def _mu_inv(self, r_u):
        return self.eq.mass_inverse_uv(r_u)

    def _me_inv(self, r_e):
        return self.eq.mass_inverse_elev(r_e)

    def _schur_apply(self, v):
        """S v = M_eta v - (theta dt)^2 D M_u^-1 G v."""
        c = self.coeff
        return self.Me(v) - c * c * self.D(self._mu_inv(self.G(v)))

    def _schur_solve(self, b):
        """Fixed-iteration CG on the SPD wave operator, preconditioned by
        the elevation mass inverse."""
        tiny = torch.finfo(b.dtype).tiny
        x = torch.zeros_like(b)
        r = b
        z = self._me_inv(r)
        p = z
        rz = _dot(r, z)
        for _ in range(self.n_inner):
            Ap = self._schur_apply(p)
            alpha = rz / torch.clamp_min(_dot(p, Ap), tiny)
            x = _tree_axpy(alpha, p, x)
            r = _tree_axpy(-alpha, Ap, r)
            z = self._me_inv(r)
            rz_new = _dot(r, z)
            beta = rz_new / torch.clamp_min(rz, tiny)
            p = _tree_axpy(beta, p, z)
            rz = rz_new
        return x

    # -- the preconditioner ----------------------------------------------
    def __call__(self, r):
        """Approximate J^-1 r by block elimination (ref
        ``assembledschur.py:40-75`` apply)."""
        c = self.coeff
        du_star = self._mu_inv(r["uv"])
        rhs_e = r["elev"] + c * self.D(du_star)
        de = self._schur_solve(rhs_e)
        du = _tree_axpy(c, self._mu_inv(self.G(de)), du_star)
        return {"uv": du, "elev": de}
