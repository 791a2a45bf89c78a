r"""FlowSolver — the 3D baroclinic mode-split step.

Port of ``thetis_tpu/model/flowsolver3d.py``: a 2D barotropic mode (the
reduced :class:`ModeSplit2DEquations`, stepped by the assembled
semi-implicit CrankNicolson) coupled to the 3D momentum of the deviation
velocity, packed tracer transport, linear or Jackett EOS -> baroclinic
head -> internal pressure gradient, the weak flux-consistent vertical
velocity, the vertex limiter and implicit vertical viscosity/diffusion on
a sigma-layer ALE mesh.

Per step (``_step``): baroclinicity from the current state -> 2D CN solve
forced by the lagged ``split_residual`` -> ALE geometry and mesh velocity
-> SSPRK22 ALE stages of uv_3d and of the packed tracers (each with the
uniform "ones" consistency field) -> implicit vertical mixing (two
tridiagonal launches: both velocity components, then each tracer) ->
depth-average coupling.  A time loop is a Python loop over ``_step``
(:meth:`FlowSolver.advance_n`), where the reference scans it.

Entered as the reference is: ``FlowSolver(mesh2d, depth, nz)``,
``options.update({...})``, ``initialize()``,
``assign_initial_conditions(...)``, ``_get_state()``,
``_gather_swe_fields()``, then ``_step(state, swe_fields, {})``.

Not ported yet, and raising ``NotImplementedError`` when selected: the
LeapFrogAM3 stepper, GLS turbulence, Smagorinsky viscosity,
``dt_mode`` other than '3d' and the automatic time step, the fixed-mesh
mode, the quadratic head/density, the round-1 (non mode-split) 2D
coupling, tracer sources and the per-tracer path they need, 3D boundary
conditions (ROADMAP A7); exporters, callbacks and ``iterate`` (A10).
The CG ``P1_2d`` space of the reference is not created: the step never
uses it, and the port's function spaces are DG only.
"""
import numpy as np
import torch

from ..config import physical_constants
from ..equations.eos import JackettEquationOfState, LinearEquationOfState
from ..equations.limiter import VertexBasedP1DGLimiter3D
from ..equations.momentum_3d import (MomentumEquation3D,
                                     vertical_viscosity_implicit)
from ..equations.shallowwater_2d import ModeSplit2DEquations
from ..equations.tracer_3d import TracerEquation3D
from ..equations.turbulence import vdiff_implicit
from ..equations.utility3d import (BaroclinicHeadCalculator, DensitySolver,
                                   VerticalVelocitySolver,
                                   expand_function_to_3d)
from ..fem.assembly import DGAssembler
from ..fem.assembly3d import Assembler3D
from ..fem.functionspace import Function, FunctionSpace
from ..mesh.extruded import ExtrudedMesh
from ..solvers.newton import NewtonParameters
from ..timeintegration.steppers import CrankNicolson
from .field_defs import FieldDict
from .options import ModelOptions2d

__all__ = ["FlowSolver", "ModelOptions3d"]


class ModelOptions3d(ModelOptions2d):
    """3D options: the 2D set plus the 3D solver's switches, with the
    reference's names and defaults."""

    def __init__(self):
        super().__init__()
        for k, v in dict(
            solve_salinity=True,
            solve_temperature=True,
            use_implicit_vertical_diffusion=True,
            use_bottom_friction=True,
            use_turbulence=False,
            use_turbulence_advection=False,
            equation_of_state_options=None,
            use_smagorinsky_viscosity=False,
            smagorinsky_coefficient=0.1,
            use_limiter_for_velocity=False,
            use_baroclinic_formulation=True,
            timestepper_type="CrankNicolson",  # or 'SSPRK22' (2-stage ALE)
            equation_of_state_type="linear",
            use_quadratic_pressure=False,
            use_quadratic_density=False,
            internal_pg_scalar=None,
            constant_temperature=10.0,
            constant_salinity=35.0,
            vertical_viscosity=1e-4,
            vertical_diffusivity=1e-5,
            bottom_roughness=0.005,
            turbulence_model_options=None,
            use_modesplit_2d=True,
            use_ale_moving_mesh=True,
            use_flux_consistent_w=True,
            vertical_velocity_scale=1e-4,
            use_automatic_timestep=False,
            dt_mode="3d",
            timestep_2d=10.0,
            cfl_2d=1.0,
            cfl_3d=1.0,
            barotropic_solver_parameters=None,
            barotropic_preconditioner="assembled_schur",
            barotropic_pc_inner_iterations=8,
            momentum_source_3d=None,
            temperature_source_3d=None,
            salinity_source_3d=None,
            check_volume_conservation_3d=False,
            check_salinity_conservation=False,
            check_salinity_overshoot=False,
            check_temperature_conservation=False,
            check_temperature_overshoot=False,
        ).items():
            object.__setattr__(self, k, v)
        self._freeze()


def _unported(what, item="A7"):
    return NotImplementedError(
        f"{what} is not ported to thetis_tpu_torch yet (ROADMAP {item})")


class FlowSolver:
    """The 3D mode-split solver on one device (``mesh2d.device``, in
    ``mesh2d.dtype``)."""

    def __init__(self, mesh2d, bathymetry_2d, n_layers, options=None,
                 extrude_options=None):
        """
        :arg bathymetry_2d: a scalar depth, a CG1 (nv,) or P1DG (nc, 3)
            array or tensor, or a DG :class:`Function`
        :arg extrude_options: optional dict: ``sigma`` gives the (nz+1,)
            interface distribution in [0, 1] directly; ``z_stretch_fact``
            (s >= 1) refines toward the surface with
            ``sigma_j = 1 - (1 - j/nz)**s``
        """
        self.mesh2d = mesh2d
        self.n_layers = int(n_layers)
        self.extrude_options = dict(extrude_options or {})
        self.options = ModelOptions3d()
        if options is not None:
            self.options.update(options)
        self.bathymetry_input = bathymetry_2d
        self.bnd_functions = {"shallow_water": {}, "momentum": {},
                              "salt": {}, "temp": {}}
        self._initialized = False

    def _tensor(self, v):
        """A value as a tensor on the mesh's device and dtype."""
        if isinstance(v, Function):
            v = v.data
        return torch.as_tensor(v, dtype=self.mesh2d.dtype,
                               device=self.mesh2d.device)

    # ------------------------------------------------------------------
    def create_function_spaces(self):
        mesh = self.mesh2d
        self.function_spaces = type("FS", (), {})()
        fs = self.function_spaces
        fs.H_2d = FunctionSpace(mesh, "DG", 1)
        fs.U_2d = FunctionSpace(mesh, "DG", 1, dim=2)
        self.asm = DGAssembler(mesh, fs.H_2d)
        sigma = self.extrude_options.get("sigma")
        stretch = self.extrude_options.get("z_stretch_fact")
        if sigma is None and stretch is not None:
            s = float(stretch)
            sigma = 1.0 - (1.0 - np.linspace(0.0, 1.0,
                                             self.n_layers + 1)) ** s
            sigma[0], sigma[-1] = 0.0, 1.0
        self.extruded = ExtrudedMesh(mesh, self.n_layers, sigma=sigma)
        self.asm3d = Assembler3D(mesh, self.asm, self.extruded)

    def create_fields(self):
        if not hasattr(self, "function_spaces"):
            self.create_function_spaces()
        mesh, nz = self.mesh2d, self.n_layers
        o = self.options
        b = self._tensor(self.bathymetry_input)
        if b.dim() == 0:
            bathy_cell = b.expand(mesh.nc, 3).clone()
        elif tuple(b.shape) == (mesh.nv,):
            bathy_cell = b[mesh.cells]
        else:
            bathy_cell = b
        self.bathy_cell = bathy_cell
        self.fields = FieldDict()
        f = self.fields
        H = self.function_spaces.H_2d
        f.elev_2d = Function(H)
        f.uv_2d = Function(self.function_spaces.U_2d)
        shape3 = (mesh.nc, 3, nz, 2)
        self.shape3 = shape3

        def full(value, shape=shape3):
            return Function(H, data=torch.full(
                shape, float(value), dtype=mesh.dtype, device=mesh.device))

        f.uv_3d = full(0.0, shape3 + (2,))
        f.w_3d = full(0.0)
        f.salt_3d = full(o.constant_salinity)
        f.temp_3d = full(o.constant_temperature)
        f.density_3d = full(0.0)
        f.tke_3d = full(1e-6)
        f.psi_3d = full(1e-14)
        # depth average of the previous step's 3D momentum tendency: the
        # 2D mode's coupling source
        f.split_residual_2d = Function(self.function_spaces.U_2d)

    def _check_options(self):
        o = self.options
        ts = str(o.timestepper_type)
        if ts == "LeapFrogAM3":
            raise _unported("the LeapFrogAM3 3D stepper")
        if ts not in ("CrankNicolson", "SSPRK22", "TwoStageRK"):
            raise ValueError(f"unknown 3D time stepper {ts!r}")
        checks = [
            (o.use_turbulence, "GLS turbulence"),
            (o.use_smagorinsky_viscosity, "Smagorinsky viscosity"),
            (str(o.dt_mode) != "3d", f"dt_mode={o.dt_mode!r}"),
            (o.use_automatic_timestep, "the automatic 3D time step"),
            (not o.use_ale_moving_mesh, "the fixed-mesh mode"),
            (o.use_quadratic_pressure or o.use_quadratic_density,
             "the quadratic baroclinic head/density"),
            (not o.use_modesplit_2d, "the non mode-split 2D coupling"),
            (o.temperature_source_3d is not None
             or o.salinity_source_3d is not None,
             "3D tracer sources (the per-tracer path)"),
            (any(self.bnd_functions.get(k) for k in
                 ("momentum", "salt", "temp")),
             "3D boundary conditions"),
        ]
        for bad, what in checks:
            if bad:
                raise _unported(what)

    def create_equations(self):
        self._check_options()
        if not hasattr(self, "fields"):
            self.create_fields()
        o = self.options
        self.eq_sw = ModeSplit2DEquations(
            self.mesh2d, self.asm, o,
            bathymetry=self._tensor(self.bathymetry_input),
            bnd_conditions=self.bnd_functions.get("shallow_water", {}))
        self.eq_momentum = MomentumEquation3D(self.mesh2d, self.asm3d, o)
        self.eq_salt = TracerEquation3D(self.mesh2d, self.asm3d, o,
                                        label="salt_3d")
        self.eq_temp = TracerEquation3D(self.mesh2d, self.asm3d, o,
                                        label="temp_3d")
        if o.equation_of_state_type == "full":
            self.equation_of_state = JackettEquationOfState()
        else:
            self.equation_of_state = LinearEquationOfState(
                **(o.equation_of_state_options or {}))
        self.density_solver = DensitySolver(self.equation_of_state)
        self.bhc = BaroclinicHeadCalculator(self.asm3d)
        self.w_solver = VerticalVelocitySolver(self.asm3d, self.bathy_cell)
        if o.use_limiter_for_tracers or o.use_limiter_for_velocity:
            self.tracer_limiter = VertexBasedP1DGLimiter3D(
                self.mesh2d, self.n_layers)

    def initialize(self):
        self.create_equations()
        o = self.options
        self.dt = float(o.timestep)
        # barotropic Krylov: 1e-5 relative residual, short restarts (the
        # mode-split wave CFL is O(1)); the semi-implicit system is affine
        # with 1-ring sparsity, so its exact blocks are assembled per step
        assembled = str(o.barotropic_preconditioner) in (
            "assembled_schur", "assembled")
        default_params = NewtonParameters(
            ksp_rtol=1e-5, ksp_max_it=48,
            gmres_restart=6 if assembled else 24)
        self.swe_stepper = CrankNicolson(
            self.eq_sw, self.dt, semi_implicit=True,
            solver_parameters=(o.barotropic_solver_parameters
                               or default_params),
            assembled_solve=assembled)
        self._build_step()
        self._initialized = True

    def assign_initial_conditions(self, elev=None, uv=None, salt=None,
                                  temp=None, uv_3d=None, uv_2d=None):
        if not self._initialized:
            self.initialize()
        if uv_2d is not None:
            uv = uv_2d
        f = self.fields
        mesh, nz = self.mesh2d, self.n_layers

        def to3(v):
            v = self._tensor(v)
            if v.dim() == 0:
                return v.expand(self.shape3).clone()
            if tuple(v.shape) == self.shape3:
                return v
            if tuple(v.shape) == (mesh.nv,):
                return expand_function_to_3d(v[mesh.cells], nz).clone()
            if tuple(v.shape) == (mesh.nc, 3):
                return expand_function_to_3d(v, nz).clone()
            raise ValueError(f"cannot map IC of shape {tuple(v.shape)}")

        if elev is not None:
            e = self._tensor(elev)
            if e.dim() == 0:
                e = e.expand(mesh.nc, 3).clone()
            elif tuple(e.shape) == (mesh.nv,):
                e = e[mesh.cells]
            f.elev_2d.data = e
        if uv is not None:
            f.uv_2d.data = self._tensor(uv).expand(mesh.nc, 3, 2).clone()
        if salt is not None:
            f.salt_3d.data = to3(salt)
        if temp is not None:
            f.temp_3d.data = to3(temp)
        if uv_3d is not None:
            f.uv_3d.data = self._tensor(uv_3d)

    # ------------------------------------------------------------------
    def _build_step(self):
        o = self.options
        dt = self.dt
        asm3d = self.asm3d
        ext = self.extruded
        nz = ext.nz
        bathy_cell = self.bathy_cell
        eq_mom, eq_salt = self.eq_momentum, self.eq_salt
        swe_stepper = self.swe_stepper
        density_solver, bhc, w_solver = (self.density_solver, self.bhc,
                                         self.w_solver)
        limiter = getattr(self, "tracer_limiter", None)
        rho0 = physical_constants["rho0"]
        kappa = float(physical_constants["von_karman"])
        nu_v0 = float(o.vertical_viscosity)
        mu_v0 = float(o.vertical_diffusivity)
        solve_salt, solve_temp = o.solve_salinity, o.solve_temperature
        # bottom friction: an explicit quadratic drag coefficient wins;
        # otherwise the law-of-wall log fit in the bottom element from
        # ``bottom_roughness``
        cd_opt = o.quadratic_drag_coefficient
        z0_bot = float(o.bottom_roughness or 0.005)
        use_law_of_wall = o.use_bottom_friction and cd_opt is None
        ipg_scale = o.internal_pg_scalar
        two_stage = str(o.timestepper_type) in ("SSPRK22", "TwoStageRK")
        sigma = ext.sigma

        def geometry(elev):
            return asm3d.layer_geometry(ext.z_interfaces(bathy_cell, elev))

        def baroclinicity(state, geom):
            """density -> baroclinic head -> int_pg."""
            rho = density_solver.solve(state["salt_3d"], state["temp_3d"])
            int_pg = bhc.compute_int_pg(bhc.compute_head(rho, geom), geom)
            if ipg_scale is not None:
                int_pg = float(ipg_scale) * int_pg
            return rho, int_pg

        # the packed tracer transport: every solved tracer plus the
        # uniform "ones" consistency field ride a trailing component axis
        # through ONE residual evaluation (sources excluded: they would
        # leak into the ones component)
        pack_terms = frozenset(
            ["HorizontalAdvectionTerm", "VerticalAdvectionTerm",
             "HorizontalDiffusionTerm", "VerticalDiffusionTerm"])

        def pack_residual(cp, fields3, geom):
            return eq_salt.residual(pack_terms, {"salt_3d": cp},
                                    {"salt_3d": cp}, fields3, fields3, {},
                                    geom=geom)["salt_3d"]

        def ale_combine(eq, key, u0, u_eval, fields, geom0, geom_eval,
                        geom_new, a, b):
            """Generalized ALE stage (SSPRK22 ALE):

                M_new u_new = a * M(geom0) u0
                            + b * (M(geom_eval) u_eval + dt R(u_eval))

            a=0, b=1 is the forward predictor stage; a=b=1/2 the SSPRK22
            averaging corrector."""
            r = eq.residual("all", {key: u_eval}, {key: u_eval}, fields,
                            fields, {}, geom=geom_eval)
            acc = b * (eq.mass_term({key: u_eval}, geom_eval)[key]
                       + dt * r[key])
            if a != 0.0:
                acc = acc + a * eq.mass_term({key: u0}, geom0)[key]
            return eq.mass_inverse({key: acc}, geom_new)[key]

        def ale_advance(eq, key, u0, fields, geom_old, geom_new,
                        limit=False):
            """One forward ALE stage, or the two SSPRK22 ALE stages; with
            ``limit`` the vertex limiter after every stage."""
            def lim(x):
                return limiter.apply(x) if limit else x

            u1 = lim(ale_combine(eq, key, u0, u0, fields, geom_old, geom_old,
                                 geom_new, 0.0, 1.0))
            if not two_stage:
                return u1
            return lim(ale_combine(eq, key, u0, u1, fields, geom_old,
                                   geom_new, geom_new, 0.5, 0.5))

        def pack_fix(cp_out, cp0, limit):
            """Post-stage packed consistency fix: subtract the uniform-field
            drift (last component - 1) from every tracer, limit each
            component, reset the ones carrier."""
            drift = cp_out[..., -1:] - 1.0
            tr = cp_out[..., :-1] - cp0[..., :-1] * drift
            if limit:
                tr = limiter.apply(tr)
            return torch.cat([tr, torch.ones_like(cp_out[..., -1:])], dim=-1)

        def pack_advance(cp0, fields3, geom_old, geom_new, limit=False):
            """Packed-tracer ALE advance: the stages of ``ale_advance``,
            with the drift from the ones component of the same residual
            pass."""
            def stage(cpa, cpe, ga, ge, gn, a, b):
                r = pack_residual(cpe, fields3, ge)
                acc = b * (asm3d.mass_apply(cpe, ge) + dt * r)
                if a != 0.0:
                    acc = acc + a * asm3d.mass_apply(cpa, ga)
                return asm3d.mass_inverse(acc, gn)

            c1 = stage(cp0, cp0, geom_old, geom_old, geom_new, 0.0, 1.0)
            c1 = pack_fix(c1, cp0, limit)
            if not two_stage:
                return c1
            c2 = stage(cp0, c1, geom_old, geom_new, geom_new, 0.5, 0.5)
            return pack_fix(c2, cp0, limit)

        def mesh_velocity(elev_old, elev_new):
            """w_mesh at layer dof points: dz/dt at fixed sigma =
            sigma * d(eta)/dt."""
            deta_dt = (elev_new - elev_old) / dt          # (nc, 3)
            wm_if = sigma * deta_dt[..., None]            # (nc, 3, nz+1)
            return torch.stack([wm_if[..., :-1], wm_if[..., 1:]], dim=-1)

        def pre(state):
            """Baroclinicity diagnostics feeding the 2D solve: returns
            ``(geom0, int_pg, src_2d)`` with the lagged split residual as
            the 2D momentum source."""
            geom0 = geometry(state["elev"])
            int_pg = (baroclinicity(state, geom0)[1]
                      if o.use_baroclinic_formulation else None)
            return geom0, int_pg, state["split_residual"]

        def post(state, sw, geom0, int_pg, swe_fields):
            """Everything after the barotropic solve: ALE, 3D advection,
            mixing, coupling."""
            geom = geometry(sw["elev"])
            w_mesh = mesh_velocity(state["elev"], sw["elev"])
            # advective velocity: the CN midpoint 2D velocity satisfies
            # the discrete 2D continuity with d(eta)/dt, so tracers
            # advected by it (and by w from it) stay consistent with the
            # moving mesh
            uv_adv = state["uv_3d"] + expand_function_to_3d(
                0.5 * (state["uv"] + sw["uv"]), nz)
            w_adv = (w_solver.solve_weak(uv_adv, geom0)
                     if o.use_flux_consistent_w
                     else w_solver.solve(uv_adv, geom0))
            uv_total = state["uv_3d"] + expand_function_to_3d(sw["uv"], nz)
            fields3 = {
                "w_3d": w_adv,
                "w_mesh_3d": w_mesh,
                "int_pg_3d": int_pg,
                "coriolis": swe_fields.get("coriolis"),
                # Coriolis acts on the deviation in the 3D mode
                "coriolis_bg_uv_2d": sw["uv"],
                "viscosity_h": swe_fields.get("viscosity_h"),
                "momentum_source_3d": swe_fields.get("momentum_source_3d"),
            }
            fields3 = {k: v for k, v in fields3.items() if v is not None}
            uv_new = ale_advance(eq_mom, "uv_3d", uv_total, fields3, geom0,
                                 geom, limit=o.use_limiter_for_velocity)

            # tracers, advected by the continuity-consistent velocity
            tr_fields = {"uv_3d": uv_adv, "w_3d": w_adv, "w_mesh_3d": w_mesh,
                         "diffusivity_h": swe_fields.get("diffusivity_h"),
                         "diffusivity_v": mu_v0}
            tr_fields = {k: v for k, v in tr_fields.items() if v is not None}
            new_state = dict(state)
            tracer_keys = [k for k, on in (("salt_3d", solve_salt),
                                           ("temp_3d", solve_temp)) if on]
            if tracer_keys:
                ones = torch.ones_like(state[tracer_keys[0]])
                cp0 = torch.stack([state[k] for k in tracer_keys] + [ones],
                                  dim=-1)
                cp_new = pack_advance(cp0, tr_fields, geom0, geom,
                                      limit=o.use_limiter_for_tracers)
                for i, k in enumerate(tracer_keys):
                    new_state[k] = cp_new[..., i]

            # implicit vertical mixing, wind surface stress and bottom
            # friction
            if o.use_implicit_vertical_diffusion:
                Dn = geom["Delta_nodes"]
                nu_col = torch.full_like(new_state["salt_3d"], nu_v0)
                mu_col = torch.full_like(new_state["salt_3d"], mu_v0)
                cd_val = None
                if use_law_of_wall:
                    # the bottom velocity lives z_b = h_b/2 above the bed:
                    # Cd = (kappa / ln((z_b + z0)/z0))^2
                    z_b = 0.5 * Dn[:, :, 0] + z0_bot
                    cd_val = (kappa / torch.log(z_b / z0_bot)) ** 2
                elif o.use_bottom_friction:
                    cd_val = float(cd_opt)
                stress_top = None
                wind = swe_fields.get("wind_stress")
                if wind is not None:
                    stress_top = (wind / rho0).expand(
                        tuple(uv_new.shape[:2]) + (2,))
                uv_new = vertical_viscosity_implicit(
                    uv_new, nu_col, Dn, dt, stress_top=stress_top,
                    bottom_drag=cd_val,
                    uv_bot=uv_new[:, :, 0, 0] if cd_val is not None
                    else None)
                for k in tracer_keys:
                    new_state[k] = vdiff_implicit(new_state[k], mu_col, Dn,
                                                  dt)

            # 2D<->3D coupling: remove the depth average (the 2D solution
            # carries it); the removed average relative to the 2D flow,
            # over dt, is the next step's 2D momentum source
            uv_dav = asm3d.vertical_integral(uv_new, geom, average=True)
            new_state["uv_3d"] = uv_new - expand_function_to_3d(uv_dav, nz)
            new_state["split_residual"] = (uv_dav - sw["uv"]) / dt
            new_state["uv"] = sw["uv"]
            new_state["elev"] = sw["elev"]
            return new_state

        def step(state, swe_fields, bnd_sw):
            geom0, int_pg, src_2d = pre(state)
            user_src = swe_fields.get("momentum_source_user")
            if user_src is not None:
                src_2d = src_2d + user_src
            swe_fields = dict(swe_fields)
            swe_fields["momentum_source"] = src_2d
            sw = swe_stepper.advance(
                0.0, {"uv": state["uv"], "elev": state["elev"]},
                swe_fields, swe_fields, bnd_sw)
            return post(state, sw, geom0, int_pg, swe_fields)

        self._pre_fn = pre
        self._post_fn = post
        self._step = step

    def advance_n(self, state, swe_fields, bnd_sw, n):
        """``n`` steps of :meth:`_step` in a Python loop."""
        for _ in range(int(n)):
            state = self._step(state, swe_fields, bnd_sw)
        return state

    # ------------------------------------------------------------------
    def _get_state(self):
        f = self.fields
        return {
            "uv": f.uv_2d.data, "elev": f.elev_2d.data,
            "uv_3d": f.uv_3d.data,
            "salt_3d": f.salt_3d.data, "temp_3d": f.temp_3d.data,
            "tke_3d": f.tke_3d.data, "psi_3d": f.psi_3d.data,
            "split_residual": f.split_residual_2d.data,
        }

    def _gather_swe_fields(self):
        o = self.options
        mesh = self.mesh2d
        t = self._tensor
        out = {"lax_friedrichs_velocity_scaling_factor":
               t(float(o.lax_friedrichs_velocity_scaling_factor))}
        if o.coriolis_frequency is not None:
            out["coriolis"] = t(o.coriolis_frequency)
        if o.momentum_source_2d is not None:
            v = t(o.momentum_source_2d)
            if v.dim() and v.shape[0] == mesh.nv:
                v = v[mesh.cells]
            out["momentum_source_user"] = v
        if o.wind_stress is not None:
            v = t(o.wind_stress)
            if v.dim() and v.shape[0] == mesh.nv:
                v = v[mesh.cells]       # CG1 -> P1DG cell nodes
            out["wind_stress"] = v
        if o.horizontal_viscosity is not None:
            # a constant: the 2D viscosity fields of the reference are not
            # ported (float() of an array raises)
            out["viscosity_h"] = t(float(o.horizontal_viscosity))
        if o.horizontal_diffusivity is not None:
            out["diffusivity_h"] = t(float(o.horizontal_diffusivity))
        if o.volume_source_2d is not None:
            v = t(o.volume_source_2d)
            if v.dim() and v.shape[0] == mesh.nv:
                v = v[mesh.cells]
            out["volume_source"] = v
        if o.momentum_source_3d is not None:
            out["momentum_source_3d"] = t(o.momentum_source_3d)
        if o.quadratic_drag_coefficient is not None and \
                not o.use_bottom_friction:
            # with 3D bottom friction the drag acts on the 3D momentum;
            # forwarding it to the 2D mode as well would count it twice
            out["quadratic_drag_coefficient"] = t(
                float(o.quadratic_drag_coefficient))
        return out
