"""Time integrators (port of ``thetis_tpu/timeintegration/steppers.py``).

Each stepper exposes

    ``advance(t, solution, fields, fields_old, bnd_values) -> solution``

on dicts of tensors.  The reference wraps this in ``jax.jit``/``lax.scan``;
here a time loop is a plain Python loop over ``advance``.

Ported: :class:`ForwardEuler`, :class:`SSPRK33`, :class:`ERKGeneric` (the
explicit tableaux of ``rungekutta.py``), and the whole
:class:`CrankNicolson` / :class:`BackwardEuler`: the matrix-free Newton
branch (``'mass'``, ``'schur'`` or a prebuilt callable preconditioner,
e.g. the setup-time ``AssembledWavePC``), and the assembled semi-implicit
branch, analytic or by colour probing, with an optional coarse or Schur
fieldsplit preconditioner and the Picard ``linearization_state`` hook.
Implicit steppers keep the last solve's counters in ``self.stats``
(Newton iterations, FGMRES cycles, final relative residuals).

Not ported yet (``get_stepper`` raises ``NotImplementedError`` naming
ROADMAP A8): the DIRK family, IMEX, PressureProjectionPicard and
SteadyState.
"""
import numpy as np

from ..solvers.newton import NewtonParameters, newton_solve
from .rungekutta import SCHEMES

__all__ = ["TimeIntegrator", "ForwardEuler", "SSPRK33", "CrankNicolson",
           "BackwardEuler", "ERKGeneric", "get_stepper"]


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


class ForwardEuler(TimeIntegrator):
    """ref ``timeintegrator.py:115-165``."""

    cfl_coeff = 1.0

    def advance(self, t, solution, fields, fields_old, bnd_values):
        eq = self.equation
        r = eq.residual("all", solution, solution, fields_old, fields_old,
                        bnd_values)
        return _tree_lc([(1.0, solution), (self.dt, eq.mass_inverse(r))])


class SSPRK33(TimeIntegrator):
    """3-stage SSP RK in Shu-Osher form (ref ``rungekutta.py:955``)."""

    cfl_coeff = 1.0

    def _stage_rhs(self, u, fields, bnd_values):
        eq = self.equation
        r = eq.residual("all", u, u, fields, fields, bnd_values)
        return eq.mass_inverse(r)

    def advance(self, t, solution, fields, fields_old, bnd_values):
        dt = self.dt
        u = solution
        k0 = self._stage_rhs(u, fields_old, bnd_values)
        u1 = _tree_lc([(1.0, u), (dt, k0)])
        k1 = self._stage_rhs(u1, fields, bnd_values)
        u2 = _tree_lc([(0.75, u), (0.25, u1), (0.25 * dt, k1)])
        k2 = self._stage_rhs(u2, fields, bnd_values)
        return _tree_lc([(1.0 / 3.0, u), (2.0 / 3.0, u2), (2.0 / 3.0 * dt, k2)])


class ERKGeneric(TimeIntegrator):
    """Generic explicit RK from a Butcher tableau
    (ref ``rungekutta.py:762-953``)."""

    def __init__(self, equation, dt, scheme="SSPRK33", options=None):
        super().__init__(equation, dt, options)
        tb = SCHEMES[scheme]()
        if tb.is_implicit:
            raise ValueError(f"{scheme} is not an explicit tableau")
        self.a, self.b = tb.a, tb.b
        self.n_stages = tb.n_stages
        self.cfl_coeff = tb.cfl_coeff

    def advance(self, t, solution, fields, fields_old, bnd_values):
        eq = self.equation
        dt = self.dt
        ks = []
        for i in range(self.n_stages):
            u_i = _tree_lc(
                [(1.0, solution)]
                + [(dt * self.a[i][j], ks[j]) for j in range(i)
                   if self.a[i][j] != 0.0]
            )
            f = fields_old if i == 0 else fields
            r = eq.residual("all", u_i, u_i, f, f, bnd_values)
            ks.append(eq.mass_inverse(r))
        return _tree_lc(
            [(1.0, solution)]
            + [(dt * float(bi), k) for bi, k in zip(self.b, ks) if bi != 0.0]
        )


class CrankNicolson(TimeIntegrator):
    """theta-scheme (ref ``timeintegrator.py:168-252``).

    :kwarg semi_implicit: Picard linearisation about the old state (one
        linear solve per step, ref 'ksponly')
    :kwarg assembled_solve: (semi-implicit only) assemble the exact step
        system as 1-ring blocks and solve it with block-Jacobi FGMRES on
        ring matvecs, two-level preconditioned by ``coarse`` if given
    :kwarg preconditioner: for the matrix-free Newton branch: 'mass'
        (default), 'schur' (a :class:`~..solvers.schur.WaveEquationSchurPC`
        built at the old solution each step) or a prebuilt callable (e.g.
        a setup-time :class:`~..solvers.assembled.AssembledWavePC`)."""

    cfl_coeff = np.inf

    def __init__(self, equation, dt, options=None, theta=0.5,
                 semi_implicit=False, solver_parameters=None,
                 preconditioner="mass", schur_inner_iterations=10,
                 assembled_solve=False, coarse=None):
        super().__init__(equation, dt, options)
        self.theta = float(theta)
        self.semi_implicit = semi_implicit
        self.preconditioner = (preconditioner if callable(preconditioner)
                               else str(preconditioner))
        self.schur_inner_iterations = int(schur_inner_iterations)
        self.assembled_solve = bool(assembled_solve) and semi_implicit
        #: optional setup-time CoarseCorrection / SchurFieldsplitPC for the
        #: assembled KSP
        self.coarse = coarse
        self.params = solver_parameters or NewtonParameters()
        if semi_implicit:
            # Picard linearisation: one linear solve per step, terms are
            # A(u_old) u (ref L186-211 'ksponly')
            self.params.snes_max_it = 1
            self.params.snes_rtol = 1e-16
        #: counters of the last ``advance``
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values,
                linearization_state=None, solution_prev=None):
        """One theta step.  ``linearization_state`` overrides the
        semi-implicit lagged state (the Picard re-linearization hook, ref
        ``timeintegrator.py:75``).

        ``solution_prev`` (optional) enables the extrapolated Krylov warm
        start on the assembled path: the solve starts from ``2 u_n -
        u_{n-1}``.  Opt-in, as in the reference; only the Krylov initial
        guess changes."""
        eq = self.equation
        dt, th = self.dt, self.theta
        u_old = solution
        u_lag = (linearization_state if linearization_state is not None
                 else u_old)
        stats = {}
        self.stats = stats
        const = []

        def F(u):
            if not const:
                m_old = eq.mass_term(u_old)
                r_expl = eq.residual("all", u_old, u_old, fields_old,
                                     fields_old, bnd_values)
                const.append(_tree_lc([(-1.0, m_old),
                                       (-(1 - th) * dt, r_expl)]))
            u_nl = u_lag if self.semi_implicit else u
            r_impl = eq.residual("all", u, u_nl, fields, fields, bnd_values)
            return _tree_lc(
                [(1.0, eq.mass_term(u)), (-th * dt, r_impl), (1.0, const[0])]
            )

        if self.assembled_solve:
            return self._assembled_advance(F, u_old, u_lag, fields,
                                           fields_old, bnd_values,
                                           linearization_state,
                                           solution_prev, stats)

        if callable(self.preconditioner):
            pc = self.preconditioner
        elif self.preconditioner == "schur":
            from ..solvers.schur import WaveEquationSchurPC

            pc = WaveEquationSchurPC(
                eq, dt, th, u_old, fields, bnd_values,
                inner_iterations=self.schur_inner_iterations,
            )
        else:
            pc = eq.mass_inverse
        return newton_solve(F, u_old, precond=pc, params=self.params,
                            stats=stats)

    def _assembled_advance(self, F, u_old, u_lag, fields, fields_old,
                           bnd_values, linearization_state, solution_prev,
                           stats):
        """The step system is affine in the solution with 1-ring sparsity:
        its exact blocks (analytic value-space assembly, or colour
        probing where that does not apply) are solved by FGMRES on ring
        matvecs, warm-started from the old solution."""
        from ..solvers.assembled import (
            PackedState, assemble_affine_operator, cell_to_T, ring_apply_T,
            ring_gmres, ring_tables)

        eq = self.equation
        dt, th = self.dt, self.theta
        ps = PackedState(u_old)
        ring, valid = ring_tables(eq.mesh)
        x_old = ps.pack(u_old)
        x_warm = (2.0 * x_old - ps.pack(solution_prev)
                  if solution_prev is not None else x_old)
        # the analytic path linearizes the (possibly nonlinear W&D)
        # displacement mass at u_lag; probing linearizes it at u_old —
        # identical unless a Picard re-linearization state is passed
        wd = getattr(getattr(eq, "depth", None), "use_wetting_and_drying",
                     False)
        analytic = (hasattr(eq, "assemble_operator_blocks")
                    and getattr(eq.asm, "ndofs", 3) == 3
                    and not (wd and linearization_state is not None))
        r0 = None
        if analytic:
            if fields is fields_old and linearization_state is None:
                # r_impl(u_old) == r_expl: F(u_old) = -dt * r_expl, with
                # r_expl projected from the assembly's own linearization
                # primal (no separate residual pass)
                blocks_T, r_lag = eq.assemble_operator_blocks(
                    u_lag, fields, bnd_values, th * dt, return_residual=True)
                F_old = _tree_lc([(-dt, r_lag)])
            else:
                blocks_T = eq.assemble_operator_blocks(
                    u_lag, fields, bnd_values, th * dt)
                F_old = F(u_old)
            f_old = ps.pack(F_old)
            # b is only needed for the convergence anchor ||b||; the
            # warm-start residual b - A x_old == -F_old is known in closed
            # form (saves one block matvec)
            b = ring_apply_T(blocks_T, x_old, ring, valid) - f_old
            r0 = -f_old
        else:
            blocks, f0 = assemble_affine_operator(
                lambda x: ps.pack(F(ps.unpack(x))), x_old, eq.mesh)
            blocks_T = cell_to_T(blocks)
            b = -f0
        x = ring_gmres(
            blocks_T, ring, valid, b, x0=x_warm,
            r0=(r0 if solution_prev is None else None),
            rtol=self.params.ksp_rtol,
            restart=self.params.gmres_restart,
            max_cycles=max(
                1, self.params.ksp_max_it // self.params.gmres_restart),
            coarse=self.coarse, stats=stats)
        return ps.unpack(x)


class BackwardEuler(CrankNicolson):
    def __init__(self, equation, dt, options=None, **kw):
        kw.pop("theta", None)
        super().__init__(equation, dt, options, theta=1.0, **kw)


#: steppers of the reference not ported yet (ROADMAP A8)
_UNPORTED = frozenset([
    "DIRK22", "DIRK33", "DIRK23", "DIRK43", "DIRKLSPUM2", "DIRKLPUM2",
    "ESDIRKMidpoint", "ESDIRKTrapezoid", "ImplicitMidpoint", "SteadyState",
    "SSPIMEX", "IMEXLPUM2", "IMEXLSPUM2", "IMEXEuler", "IMEXMidpoint",
    "PressureProjectionPicard",
])


def get_stepper(name, equation, dt, options=None, **kw):
    """Stepper factory mirroring the reference's registry
    (``solver2d.py:662-672``)."""
    name = str(name)
    if name == "ForwardEuler":
        return ForwardEuler(equation, dt, options)
    if name == "SSPRK33":
        return SSPRK33(equation, dt, options)
    if name == "CrankNicolson":
        return CrankNicolson(equation, dt, options, **kw)
    if name == "BackwardEuler":
        return BackwardEuler(equation, dt, options, **kw)
    if name in ("ERKMidpoint", "ERKLSPUM2", "ERKLPUM2"):
        return ERKGeneric(equation, dt, scheme=name, options=options)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"time stepper {name!r} is not ported to thetis_tpu_torch yet "
            "(ROADMAP A8)")
    raise ValueError(f"unknown time stepper: {name}")
