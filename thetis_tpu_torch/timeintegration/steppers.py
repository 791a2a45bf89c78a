"""Time integrators (port of ``thetis_tpu/timeintegration/steppers.py``).

Each stepper exposes

    ``advance(t, solution, fields, fields_old, bnd_values) -> solution``

on dicts of tensors.  The reference wraps this in ``jax.jit``/``lax.scan``;
here a time loop is a plain Python loop over ``advance``.

Every stepper of the reference: :class:`ForwardEuler`, :class:`SSPRK33`,
:class:`ERKGeneric` (the explicit tableaux of ``rungekutta.py``),
:class:`CrankNicolson` / :class:`BackwardEuler` (the matrix-free Newton
branch with a ``'mass'``, ``'schur'`` or prebuilt callable preconditioner,
e.g. the setup-time ``AssembledWavePC``, and the assembled semi-implicit
branch, analytic or by colour probing, with an optional coarse or Schur
fieldsplit preconditioner and the Picard ``linearization_state`` hook),
:class:`DIRKGeneric` (k-form), :class:`DIRKUForm` (u-form, stiffly
accurate; its semi-implicit stages solved on the assembled ring operator
like the CN), :class:`PressureProjectionPicard`, :class:`SteadyState`
and, in ``implicitexplicit.py``, the IMEX pairs.  Implicit steppers keep
the last step's counters in ``self.stats`` (Newton iterations, FGMRES
cycles, final relative residuals; a DIRK step sums them over its
implicit stages, counted in ``stages``).
"""
import numpy as np
import torch

from ..solvers.newton import NewtonParameters, newton_solve
from .rungekutta import SCHEMES

__all__ = ["TimeIntegrator", "ForwardEuler", "SSPRK33", "CrankNicolson",
           "BackwardEuler", "ERKGeneric", "DIRKGeneric", "DIRKUForm",
           "PressureProjectionPicard", "SteadyState", "get_stepper"]


def _tree_lc(coeffs_and_trees):
    """Linear combination of state dicts: [(a0, t0), (a1, t1), ...]."""
    out = None
    for a, t in coeffs_and_trees:
        scaled = {k: a * v for k, v in t.items()}
        out = scaled if out is None else {k: out[k] + scaled[k] for k in out}
    return out


def _zeros_like(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _add_stats(total, st):
    """Sum one implicit solve's counters into a step's."""
    total["stages"] = total.get("stages", 0) + 1
    for k in ("ksp_cycles", "newton_iterations"):
        total[k] = total.get(k, 0) + st.get(k, 0)
    for k in ("ksp_rel_residual", "snes_rel_residual"):
        if k in st:
            total[k] = max(total.get(k, 0.0), st[k])


def _semi_implicit_params(params):
    """Picard linearisation: one linear solve per implicit stage (ref
    ``timeintegrator.py:186-211`` 'ksponly')."""
    params.snes_max_it = 1
    params.snes_rtol = 1e-16


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
                # with its graph whatever the grad mode of this first call
                # (a Newton solve makes its first one without): the
                # adjoint differentiates through it
                with torch.enable_grad():
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


class DIRKGeneric(TimeIntegrator):
    """Generic k-form DIRK from a Butcher tableau
    (ref ``rungekutta.py:438-577``).

    Stage i solves  M k_i = R(u^n + dt*sum_j a_ij k_j)  for the tendency
    k_i, then u^{n+1} = u^n + dt*sum_i b_i k_i.  An explicit first stage
    (ESDIRK) is evaluated without a solve."""

    def __init__(self, equation, dt, scheme="DIRK22", options=None,
                 semi_implicit=False, solver_parameters=None):
        super().__init__(equation, dt, options)
        tb = SCHEMES[scheme]()
        if np.triu(tb.a, 1).any():
            raise ValueError(f"{scheme} is not diagonally implicit")
        self.a, self.b, self.c = tb.a, tb.b, tb.c
        self.n_stages = tb.n_stages
        self.cfl_coeff = tb.cfl_coeff
        self.semi_implicit = semi_implicit
        self.params = solver_parameters or NewtonParameters()
        if semi_implicit:
            _semi_implicit_params(self.params)
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values):
        eq = self.equation
        dt = self.dt
        self.stats = stats = {}
        ks = []
        for i in range(self.n_stages):
            base = _tree_lc([(1.0, solution)] + [
                (dt * self.a[i][j], ks[j]) for j in range(i)
                if self.a[i][j] != 0.0])
            aii = float(self.a[i][i])
            if aii == 0.0:
                r = eq.residual("all", base, base, fields, fields,
                                bnd_values)
                ks.append(eq.mass_inverse(r))
                continue

            def F(k, base=base, aii=aii):
                u = _tree_lc([(1.0, base), (dt * aii, k)])
                u_nl = base if self.semi_implicit else u
                r = eq.residual("all", u, u_nl, fields, fields, bnd_values)
                return _tree_lc([(1.0, eq.mass_term(k)), (-1.0, r)])

            k0 = ks[-1] if ks else _zeros_like(solution)
            st = {}
            ks.append(newton_solve(F, k0, precond=eq.mass_inverse,
                                   params=self.params, stats=st))
            _add_stats(stats, st)
        return _tree_lc(
            [(1.0, solution)]
            + [(dt * float(bi), k) for bi, k in zip(self.b, ks) if bi != 0.0])


class DIRKUForm(TimeIntegrator):
    """u-form DIRK for stiffly accurate tableaux (b == the last row of a):
    each stage solves for the stage *solution*, so nonlinear mass terms
    (the wetting-and-drying displacement) are exact (ref
    ``rungekutta.py:580-711`` DIRKGenericUForm, the 2D SWE's
    DIRK22/DIRK33).

    With ``assembled_solve`` (semi-implicit only) each stage system is
    affine with 1-ring sparsity: its blocks (analytic, cached per
    diagonal coefficient a_ii within a step; by colour probing under
    wetting-and-drying, whose displaced mass the analytic blocks would
    linearize at the step start) are solved by block-Jacobi FGMRES on
    ring matvecs, two-level preconditioned by ``coarse`` if given, each
    stage warm-started from the previous one."""

    def __init__(self, equation, dt, scheme="DIRK22", options=None,
                 semi_implicit=False, solver_parameters=None,
                 assembled_solve=False, coarse=None):
        super().__init__(equation, dt, options)
        self.coarse = coarse
        tb = SCHEMES[scheme]()
        if not tb.is_dirk or not np.allclose(tb.a[-1], tb.b):
            raise ValueError("u-form DIRK requires a stiffly accurate DIRK "
                             f"tableau, not {scheme}")
        self.a = tb.a
        self.n_stages = tb.n_stages
        self.cfl_coeff = tb.cfl_coeff
        self.semi_implicit = semi_implicit
        self.assembled_solve = bool(assembled_solve) and semi_implicit
        self.params = solver_parameters or NewtonParameters()
        if semi_implicit:
            _semi_implicit_params(self.params)
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values):
        eq = self.equation
        dt = self.dt
        self.stats = stats = {}
        m_old = eq.mass_term(solution)
        r_stages = []
        stage_blocks = {}
        u_i = solution
        for i in range(self.n_stages):
            aii = float(self.a[i][i])
            known = _tree_lc(
                [(-1.0, m_old)]
                + [(-dt * float(self.a[i][j]), r_stages[j])
                   for j in range(i) if self.a[i][j] != 0.0])

            def F(u, known=known, aii=aii):
                u_nl = solution if self.semi_implicit else u
                r = eq.residual("all", u, u_nl, fields, fields, bnd_values)
                return _tree_lc(
                    [(1.0, eq.mass_term(u)), (-dt * aii, r), (1.0, known)])

            st = {}
            if self.assembled_solve:
                u_i = self._assembled_stage(F, u_i, solution, fields,
                                            bnd_values, aii, stage_blocks,
                                            st)
            else:
                u_i = newton_solve(F, u_i, precond=eq.mass_inverse,
                                   params=self.params, stats=st)
            _add_stats(stats, st)
            if i < self.n_stages - 1:
                u_nl = solution if self.semi_implicit else u_i
                r_stages.append(eq.residual("all", u_i, u_nl, fields, fields,
                                            bnd_values))
        return u_i

    def _assembled_stage(self, F, u_i, solution, fields, bnd_values, aii,
                         stage_blocks, stats):
        """One stage on the assembled ring operator (the CN's
        ``_assembled_advance`` for the stage system), warm-started from
        the previous stage's solution ``u_i``."""
        from ..solvers.assembled import (
            PackedState, assemble_affine_operator, cell_to_T, ring_apply_T,
            ring_gmres, ring_tables)

        eq = self.equation
        ps = PackedState(u_i)
        ring, valid = ring_tables(eq.mesh)
        x_i = ps.pack(u_i)
        wd = getattr(getattr(eq, "depth", None), "use_wetting_and_drying",
                     False)
        analytic = (hasattr(eq, "assemble_operator_blocks")
                    and getattr(eq.asm, "ndofs", 3) == 3 and not wd)
        r0 = None
        if analytic:
            blocks_T = stage_blocks.get(aii)
            if blocks_T is None:
                blocks_T = eq.assemble_operator_blocks(
                    solution, fields, bnd_values, self.dt * aii)
                stage_blocks[aii] = blocks_T
            f_i = ps.pack(F(u_i))
            b = ring_apply_T(blocks_T, x_i, ring, valid) - f_i
            r0 = -f_i  # b - A x_i in closed form
        else:
            blocks, f0 = assemble_affine_operator(
                lambda x: ps.pack(F(ps.unpack(x))), x_i, eq.mesh)
            blocks_T = cell_to_T(blocks)
            b = -f0
        p = self.params
        x = ring_gmres(blocks_T, ring, valid, b, x0=x_i, r0=r0,
                       rtol=p.ksp_rtol, restart=p.gmres_restart,
                       max_cycles=max(1, p.ksp_max_it // p.gmres_restart),
                       coarse=self.coarse, stats=stats)
        stats["newton_iterations"] = 1
        return ps.unpack(x)


class PressureProjectionPicard(TimeIntegrator):
    """Predictor/corrector pressure-projection scheme with Picard
    iterations (ref ``timeintegrator.py:305-464``).

    Each Picard sweep solves a momentum predictor for u* (every momentum
    term, the elevation lagged at the previous iterate), then the
    wave-equation corrector for (u, eta) in which only the external
    pressure gradient and HUDiv are implicit; the predictor's pressure
    gradient at the lagged elevation is replaced by the new implicit one
    (ref L396-420).  The corrector is preconditioned by the wave-equation
    Schur complement where the elevation space is CG; on the dg-dg family
    that preconditioner is off (with the reference's message) and the
    corrector takes the mass-preconditioned solve with a larger Krylov
    budget.  Two Picard iterations give second order (ref L456-462)."""

    cfl_coeff = np.inf

    _WAVE = frozenset(["ExternalPressureGradientTerm", "HUDivTerm",
                       "ContinuitySourceTerm"])
    _EPG = frozenset(["ExternalPressureGradientTerm"])

    def __init__(self, equation, dt, options=None, theta=0.5,
                 picard_iterations=2, solver_parameters=None,
                 solver_parameters_mom=None, use_schur_pc=True,
                 schur_inner_iterations=15, semi_implicit=True):
        super().__init__(equation, dt, options)
        self.theta = float(theta)
        self.iterations = int(picard_iterations)
        self.semi_implicit = bool(semi_implicit)
        self.use_schur_pc = bool(use_schur_pc)
        self.schur_inner_iterations = int(schur_inner_iterations)
        # momentum terms: everything but the continuity row
        self._mom_terms = frozenset(
            n for (n, _, _) in equation.terms
            if n not in ("HUDivTerm", "ContinuitySourceTerm"))
        if self.use_schur_pc and not hasattr(equation, "eta_space"):
            from ..utils.log import print_output

            print_output(
                "PressureProjectionPicard: elevation space is not CG; "
                "disabling the wave-Schur preconditioner (use the dg-cg "
                "element family for the fast path)")
            self.use_schur_pc = False
            if solver_parameters is None:
                solver_parameters = NewtonParameters(
                    ksp_rtol=1e-10, ksp_max_it=240, gmres_restart=60)
        self.params = solver_parameters or NewtonParameters(
            ksp_rtol=1e-10, ksp_max_it=120, gmres_restart=30)
        self.params_mom = solver_parameters_mom or NewtonParameters(
            ksp_rtol=1e-10, ksp_max_it=48, gmres_restart=16)
        if self.semi_implicit:
            for p in (self.params, self.params_mom):
                _semi_implicit_params(p)
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values):
        from ..solvers.schur import WaveEquationSchurPC

        eq = self.equation
        dt, th = self.dt, self.theta
        self.stats = stats = {}
        u_old = solution
        m_old = eq.mass_term(u_old)
        r_mom_old = eq.residual(self._mom_terms, u_old, u_old, fields_old,
                                fields_old, bnd_values)["uv"]
        r_wave_old = eq.residual(self._WAVE, u_old, u_old, fields_old,
                                 fields_old, bnd_values)
        sol = u_old
        for _ in range(self.iterations):
            lag = sol

            # 1. momentum predictor: M_u u* = M_u u_old
            #    + dt [th R_mom(u*, eta_lag) + (1-th) R_mom(old)]
            def F_mom(us, lag=lag):
                us = us["uv"]
                st = {"uv": us, "elev": lag["elev"]}
                st_nl = lag if self.semi_implicit else st
                r = eq.residual(self._mom_terms, st, st_nl, fields, fields,
                                bnd_values)["uv"]
                mus = eq.mass_term(st)["uv"]
                return {"uv": mus - m_old["uv"] - th * dt * r
                        - (1 - th) * dt * r_mom_old}

            st = {}
            u_star = newton_solve(
                F_mom, {"uv": lag["uv"]},
                precond=lambda r: {"uv": eq.mass_inverse_uv(r["uv"])},
                params=self.params_mom, stats=st)["uv"]
            _add_stats(stats, st)

            # 2. wave corrector; in the uv row the (1-th)-weighted old
            #    pressure gradients cancel (ref L396-420)
            star_state = {"uv": u_star, "elev": lag["elev"]}
            star_nl = lag if self.semi_implicit else star_state
            epg_star = eq.residual(self._EPG, star_state, star_nl, fields,
                                   fields, bnd_values)["uv"]
            m_star = eq.mass_term(star_state)["uv"]
            const_uv = -m_star + th * dt * epg_star
            const_e = -m_old["elev"] - (1 - th) * dt * r_wave_old["elev"]

            def F(w, lag=lag, const_uv=const_uv, const_e=const_e):
                w_nl = lag if self.semi_implicit else w
                r = eq.residual(self._WAVE, w, w_nl, fields, fields,
                                bnd_values)
                m = eq.mass_term(w)
                return {"uv": m["uv"] - th * dt * r["uv"] + const_uv,
                        "elev": m["elev"] - th * dt * r["elev"] + const_e}

            if self.use_schur_pc:
                pc = WaveEquationSchurPC(
                    eq, dt, th, lag, fields, bnd_values,
                    inner_iterations=self.schur_inner_iterations)
            else:
                pc = eq.mass_inverse
            st = {}
            sol = newton_solve(F, {"uv": u_star, "elev": lag["elev"]},
                               precond=pc, params=self.params, stats=st)
            _add_stats(stats, st)
        return sol


class SteadyState(TimeIntegrator):
    """Solve the steady equations, no mass term
    (ref ``timeintegrator.py:255-302``): a line-searched Newton on the
    dense LU of the Jacobian (the reference's 'lu' + 'newtonls'
    defaults), so only for small systems."""

    cfl_coeff = np.inf

    def __init__(self, equation, dt, options=None, solver_parameters=None):
        super().__init__(equation, dt, options)
        self.params = solver_parameters or NewtonParameters(
            snes_max_it=40, line_search=True, dense=True)
        self.params.line_search = True
        self.stats = {}

    def advance(self, t, solution, fields, fields_old, bnd_values):
        eq = self.equation

        def F(u):
            r = eq.residual("all", u, u, fields, fields, bnd_values)
            return {k: -v for k, v in r.items()}

        self.stats = {}
        return newton_solve(F, solution, precond=eq.mass_inverse,
                            params=self.params, stats=self.stats)


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
    if name in ("DIRK22", "DIRK33"):
        # u-form: exact with nonlinear (wetting-drying) mass terms
        return DIRKUForm(equation, dt, scheme=name, options=options, **kw)
    if name in ("DIRK23", "DIRK43", "DIRKLSPUM2", "DIRKLPUM2",
                "ESDIRKMidpoint", "ESDIRKTrapezoid", "ImplicitMidpoint"):
        return DIRKGeneric(equation, dt, scheme=name, options=options, **kw)
    if name in ("ERKMidpoint", "ERKLSPUM2", "ERKLPUM2"):
        return ERKGeneric(equation, dt, scheme=name, options=options)
    if name == "SteadyState":
        return SteadyState(equation, dt, options, **kw)
    if name in ("SSPIMEX", "IMEXLPUM2", "IMEXLSPUM2", "IMEXEuler",
                "IMEXMidpoint"):
        from .implicitexplicit import get_imex_stepper

        return get_imex_stepper(name, equation, dt, options, **kw)
    if name == "PressureProjectionPicard":
        return PressureProjectionPicard(equation, dt, options, **kw)
    raise ValueError(f"unknown time stepper: {name}")
