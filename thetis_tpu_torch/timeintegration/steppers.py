"""Time integrators (port of ``thetis_tpu/timeintegration/steppers.py``).

Each stepper exposes

    ``advance(t, solution, fields, fields_old, bnd_values) -> solution``

on dicts of tensors.  The reference wraps this in ``jax.jit``/``lax.scan``;
here a time loop is a plain Python loop over ``advance``.

Ported so far: the :class:`TimeIntegrator` base and the assembled
semi-implicit branch of :class:`CrankNicolson`, the stepper of the 2D CN
benchmark and of the 3D barotropic mode.
"""
import numpy as np

from ..solvers.newton import NewtonParameters

__all__ = ["TimeIntegrator", "CrankNicolson", "get_stepper"]


def _tree_lc(coeffs_and_trees):
    """Linear combination of state dicts: [(a0, t0), (a1, t1), ...]."""
    out = None
    for a, t in coeffs_and_trees:
        scaled = {k: a * v for k, v in t.items()}
        out = scaled if out is None else {k: out[k] + scaled[k] for k in out}
    return out


class TimeIntegrator:
    cfl_coeff = None

    def __init__(self, equation, dt, options=None):
        self.equation = equation
        self.dt = float(dt)
        self.options = options

    def advance(self, t, solution, fields, fields_old, bnd_values):
        raise NotImplementedError


class CrankNicolson(TimeIntegrator):
    """theta-scheme (ref ``timeintegrator.py:168-252``).

    Only the semi-implicit, assembled path is ported: the step system is
    affine in the solution with 1-ring sparsity, its exact blocks are
    assembled analytically every step and solved by block-Jacobi FGMRES
    on ring matvecs.  The matrix-free Newton path raises
    ``NotImplementedError``."""

    cfl_coeff = np.inf

    def __init__(self, equation, dt, options=None, theta=0.5,
                 semi_implicit=False, solver_parameters=None,
                 assembled_solve=False):
        super().__init__(equation, dt, options)
        if not (semi_implicit and assembled_solve):
            raise NotImplementedError(
                "thetis_tpu_torch ports only the semi-implicit assembled "
                "CrankNicolson path (semi_implicit=True, "
                "assembled_solve=True)")
        self.theta = float(theta)
        self.semi_implicit = True
        self.assembled_solve = True
        # Picard linearisation: one linear solve per step, terms are
        # A(u_old) u (ref L186-211 'ksponly')
        self.params = solver_parameters or NewtonParameters()
        from ..solvers.assembled import ring_tables

        self.ring, self.valid = ring_tables(equation.mesh)

    def advance(self, t, solution, fields, fields_old, bnd_values):
        """One theta step: solve ``F(u) = M u - th dt R(u; u_old)
        - M u_old - (1-th) dt R(u_old) = 0``, which is affine in ``u``,
        warm-started from ``u_old``."""
        from ..solvers.assembled import (
            PackedState, ring_apply_T, ring_gmres)

        eq = self.equation
        dt, th = self.dt, self.theta
        u_old = solution
        ps = PackedState(u_old)
        x_old = ps.pack(u_old)
        if fields is fields_old:
            # r_impl(u_old) == r_expl: F(u_old) = -dt * r_expl, with r_expl
            # projected from the assembly's own linearization primal
            blocks, r_lag = eq.assemble_operator_blocks(
                u_old, fields, bnd_values, th * dt, return_residual=True)
            F_old = _tree_lc([(-dt, r_lag)])
        else:
            blocks = eq.assemble_operator_blocks(u_old, fields, bnd_values,
                                                 th * dt)
            m_old = eq.mass_term(u_old)
            r_expl = eq.residual("all", u_old, u_old, fields_old,
                                 fields_old, bnd_values)
            r_impl = eq.residual("all", u_old, u_old, fields, fields,
                                 bnd_values)
            const = _tree_lc([(-1.0, m_old), (-(1 - th) * dt, r_expl)])
            F_old = _tree_lc([(1.0, m_old), (-th * dt, r_impl), (1.0, const)])
        f_old = ps.pack(F_old)
        # b is only needed for the convergence anchor ||b||; the warm-start
        # residual b - A x_old == -F_old is known in closed form
        b = ring_apply_T(blocks, x_old, self.ring, self.valid) - f_old
        x = ring_gmres(
            blocks, self.ring, self.valid, b, x0=x_old, r0=-f_old,
            rtol=self.params.ksp_rtol,
            restart=self.params.gmres_restart,
            max_cycles=max(
                1, self.params.ksp_max_it // self.params.gmres_restart),
        )
        return ps.unpack(x)


def get_stepper(name, equation, dt, options=None, **kw):
    """Stepper factory mirroring the reference's registry
    (``solver2d.py:662-672``); only CrankNicolson is ported so far."""
    name = str(name)
    if name == "CrankNicolson":
        return CrankNicolson(equation, dt, options, **kw)
    raise NotImplementedError(
        f"time stepper {name!r} is not ported to thetis_tpu_torch yet")
