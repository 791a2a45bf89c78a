r"""FlowSolver — the 3D baroclinic mode-split step.

Port of ``thetis_tpu/model/flowsolver3d.py``: a 2D barotropic mode (the
reduced :class:`ModeSplit2DEquations` forced by the lagged split residual
or, with ``use_modesplit_2d=False``, the full
:class:`ShallowWaterEquations` forced by the depth-averaged internal
pressure gradient), stepped by the assembled semi-implicit CrankNicolson,
coupled to the 3D momentum of the deviation velocity, tracer transport,
linear or Jackett EOS -> baroclinic head (P1, or P2DG x P2 with
``use_quadratic_pressure``) -> internal pressure gradient, the weak
flux-consistent vertical velocity, Smagorinsky viscosity, the vertex
limiter and implicit vertical viscosity/diffusion on a sigma-layer ALE
mesh (or a fixed one, ``use_ale_moving_mesh=False``).

Per step (``_step``): baroclinicity from the current state -> 2D CN solve
-> ALE geometry and mesh velocity -> the ALE stages of uv_3d and of the
tracers (one forward stage, SSPRK22's two, or LeapFrogAM3's predictor and
corrector) -> implicit vertical mixing (tridiagonal launches: both
velocity components in one, then each tracer) -> with ``use_turbulence``
the GLS closure on the mixed fields (two more launches: k and psi; its
eddy coefficients enter the next step's mixing) -> depth-average
coupling.  The tracers ride one packed residual with the uniform "ones"
consistency field; with 3D tracer boundary values or sources each tracer
advances alone, its uniform-field drift from a residual of its own.  A
time loop is a Python loop over ``_step`` (:meth:`FlowSolver.advance_n`),
where the reference scans it.  With ``dt_mode='split'`` the 2D mode is
explicit: ``M_modesplit`` SSPRK33 substeps at ``dt_2d`` in place of the
CN solve.

Entered as the reference is: ``FlowSolver(mesh2d, depth, nz)``,
``options.update({...})``, ``bnd_functions``,
``assign_initial_conditions(...)``, ``iterate(update_forcings=...)``
(callbacks, the conservation monitors and the exporters at every
export; ``load_state`` restarts from the HDF5 checkpoints, LeapFrogAM3's
history reseeded from the restored fields as in the reference); or, a
step at a time, ``initialize()``,
``_get_state()``, ``_gather_swe_fields()``, ``_gather_bnd_sw()``, then
``_step(state, swe_fields, bnd_sw)``.  The 3D boundary values
(``bnd_functions['momentum' | 'salt' | 'temp']``) are read once, when the
step is built, as in the reference; the 2D ones at every gather.

The CG ``P1_2d`` space of the reference is not created: the step never
uses it.
"""
import numpy as np
import torch

from ..config import physical_constants
from ..equations.eos import JackettEquationOfState, LinearEquationOfState
from ..equations.limiter import VertexBasedP1DGLimiter3D
from ..equations.momentum_3d import (MomentumEquation3D,
                                     vertical_viscosity_implicit)
from ..equations.shallowwater_2d import (ModeSplit2DEquations,
                                         ShallowWaterEquations)
from ..equations.tracer_3d import TracerEquation3D
from ..equations.turbulence import (GenericLengthScaleModel, GLSModelOptions,
                                    vdiff_implicit)
from ..equations.utility3d import (BaroclinicHeadCalculator, DensitySolver,
                                   SmagorinskyViscosity,
                                   VerticalVelocitySolver,
                                   expand_function_to_3d)
from ..fem.assembly import DGAssembler
from ..fem.assembly3d import Assembler3D
from ..fem.functionspace import Function, FunctionSpace
from ..mesh.extruded import ExtrudedMesh
from ..solvers.newton import NewtonParameters
from ..timeintegration.steppers import CrankNicolson, get_stepper
from ..utils.constant import Constant
from ..utils.log import print_output
from ..utils.profiling import timed_stage
from .callback import (CallbackManager, TracerMassConservation3DCallback,
                       TracerOvershootCallBack, VolumeConservation3DCallback)
from .exporter import load_checkpoint, solver_exporters
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


def _lf_key(key):
    """The LeapFrogAM3 history key of a tracer: salt_3d -> salt_lf_old."""
    return key.replace("_3d", "_lf_old")


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
        self.simulation_time = 0.0
        self.iteration = 0
        self.i_export = 0
        self._initialized = False
        self._initial_export_done = False
        self._monitors_registered = False
        self.callbacks = CallbackManager()

    def _tensor(self, v):
        """A value as a tensor on the mesh's device and dtype."""
        if isinstance(v, Function):
            v = v.data
        elif isinstance(v, Constant):
            v = np.asarray(v)
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
        if o.use_turbulence:
            # eddy coefficients of the previous turbulence update: the
            # mixing uses them one step lagged
            go = o.turbulence_model_options or GLSModelOptions()
            f.nu_v_3d = full(go.visc_min)
            f.mu_v_3d = full(go.diff_min)
        # depth average of the previous step's 3D momentum tendency: the
        # 2D mode's coupling source
        f.split_residual_2d = Function(self.function_spaces.U_2d)

    def _check_options(self):
        o = self.options
        ts = str(o.timestepper_type)
        if ts not in ("CrankNicolson", "SSPRK22", "TwoStageRK",
                      "LeapFrogAM3"):
            raise ValueError(f"unknown 3D time stepper {ts!r}")
        if str(o.dt_mode) not in ("3d", "2d", "split"):
            raise ValueError(f"unknown dt_mode {o.dt_mode!r}")

    def create_equations(self):
        self._check_options()
        if not hasattr(self, "fields"):
            self.create_fields()
        o = self.options
        bnd = self.bnd_functions
        swe_cls = (ModeSplit2DEquations if o.use_modesplit_2d
                   else ShallowWaterEquations)
        self.eq_sw = swe_cls(
            self.mesh2d, self.asm, o,
            bathymetry=self._tensor(self.bathymetry_input),
            bnd_conditions=bnd.get("shallow_water", {}))
        self.eq_momentum = MomentumEquation3D(
            self.mesh2d, self.asm3d, o, bnd_conditions=bnd.get("momentum"))
        self.eq_salt = TracerEquation3D(self.mesh2d, self.asm3d, o,
                                        bnd_conditions=bnd.get("salt"),
                                        label="salt_3d")
        self.eq_temp = TracerEquation3D(self.mesh2d, self.asm3d, o,
                                        bnd_conditions=bnd.get("temp"),
                                        label="temp_3d")
        if o.equation_of_state_type == "full":
            self.equation_of_state = JackettEquationOfState()
        else:
            self.equation_of_state = LinearEquationOfState(
                **(o.equation_of_state_options or {}))
        self.density_solver = DensitySolver(self.equation_of_state)
        self.bhc = BaroclinicHeadCalculator(self.asm3d)
        self.w_solver = VerticalVelocitySolver(self.asm3d, self.bathy_cell)
        if o.use_smagorinsky_viscosity:
            self.smagorinsky = SmagorinskyViscosity(
                self.asm3d, cs=float(o.smagorinsky_coefficient))
        if o.use_limiter_for_tracers or o.use_limiter_for_velocity:
            self.tracer_limiter = VertexBasedP1DGLimiter3D(
                self.mesh2d, self.n_layers)
        if o.use_turbulence:
            self.gls = GenericLengthScaleModel(
                self.asm3d, o.turbulence_model_options or GLSModelOptions())
            if o.use_turbulence_advection:
                # tke/psi are advected like tracers before the column
                # physics update
                self.eq_tke = TracerEquation3D(self.mesh2d, self.asm3d, o,
                                               label="tke_3d")
                self.eq_psi = TracerEquation3D(self.mesh2d, self.asm3d, o,
                                               label="psi_3d")

    def add_callback(self, callback, eval_interval="export"):
        self.callbacks.add(callback, eval_interval)

    def _checkpoint_field_keys(self):
        """Every prognostic field of a bit-exact 3D restart (ref
        ``solver.py:1058-1059``); LeapFrogAM3's history is not among
        them (``_get_state`` reseeds it)."""
        o = self.options
        keys = ["elev_2d", "uv_2d", "uv_3d", "w_3d", "salt_3d", "temp_3d"]
        if o.use_modesplit_2d:
            keys.append("split_residual_2d")
        if o.use_turbulence:
            keys += ["tke_3d", "psi_3d", "nu_v_3d", "mu_v_3d"]
        return keys

    def create_exporters(self):
        """The visualization series and the HDF5 checkpoints (ref
        ``solver.py:1006-1073``; :func:`.exporter.solver_exporters`)."""
        self.exporters = solver_exporters(self.options, self.fields,
                                          self._checkpoint_field_keys())

    def export(self):
        """The export callbacks, then every exporter."""
        self.callbacks.evaluate(mode="export")
        for e in self.exporters.values():
            e.export(time=self.simulation_time, iteration=self.iteration)

    def load_state(self, i_export, outputdir=None, t=None, iteration=None):
        """Restart from the HDF5 checkpoints of export ``i_export``: every
        prognostic field is restored on the mesh's device, in its dtype,
        after the solver is initialized (ref ``solver.py:1006-1073``).
        The restored state counts as exported."""
        if not self._initialized:
            self.initialize()
        tload = load_checkpoint(
            self.fields, (self.options.fields_to_export_hdf5
                          or self._checkpoint_field_keys()),
            outputdir or self.options.output_directory, i_export)
        self.i_export = i_export
        self.simulation_time = (
            t if t is not None
            else (tload if tload is not None
                  else i_export * self.options.simulation_export_time))
        self.iteration = (
            iteration if iteration is not None
            else int(np.ceil(self.simulation_time / self.dt)))
        self.i_export += 1
        for e in self.exporters.values():
            e.set_next_export_ix(self.i_export)
        self._initial_export_done = True

    # -- CFL time-step bounds: host arithmetic ---------------------------
    #: stability coefficients of the coupled integrators
    _CFL_COEFFS = {"CrankNicolson": (np.inf, 1.0),
                   "SSPRK22": (np.inf, 1.0),
                   "LeapFrogAM3": (np.inf, 1.5874)}
    #: stable wave-CFL coefficient of the explicit SSPRK33 2D subcycle
    #: (dt_mode='split'); conservative DG P1 bound
    _SPLIT_2D_CFL = 1.0

    def compute_dx_factor(self):
        """Normalised horizontal node spacing for DG(p) triangles."""
        p = 1  # P1DG
        l_r = p**2 / 3.0 + 7.0 / 6.0 * p + 1.0
        return 0.5 * 0.25 / l_r

    def compute_dz_factor(self):
        return 0.5 * 0.25 * 1.0  # p = 1 interval basis

    def _min_dx(self):
        return float(np.asarray(self.mesh2d.cell_hmin_np).min())

    def _max_depth(self):
        """The deepest bathymetry node (a host read, at set-up)."""
        return float(self.bathy_cell.max())

    def _min_dz(self):
        return self._max_depth() / self.n_layers

    def compute_dt_2d(self, u_scale):
        """dt = dx / (sqrt(g h) + U)."""
        g = float(physical_constants["g_grav"])
        h = max(self._max_depth(), 0.05)
        u = np.sqrt(g * h) + float(u_scale)
        return self._min_dx() * self.compute_dx_factor() / u

    def compute_dt_h_advection(self, u_scale):
        return self._min_dx() * self.compute_dx_factor() / float(u_scale)

    def compute_dt_v_advection(self, w_scale):
        w = max(float(w_scale), 1e-12)
        return self._min_dz() * self.compute_dz_factor() / w

    def compute_dt_diffusion(self, nu_scale):
        """dt = (2 a dx)^2 / nu."""
        nu = max(float(nu_scale), 1e-12)
        min_dx = self._min_dx() * 2.0 * self.compute_dx_factor()
        return min_dx**2 / nu

    def set_time_step(self):
        """Choose/report dt from the CFL bounds and resolve the
        mode-split dt control: with ``dt_mode='split'`` the 2D mode runs
        ``M_modesplit`` explicit substeps at ``dt_2d = dt / M_modesplit``
        (``M = ceil(dt / timestep_2d)``, or from the 2D wave CFL under
        ``use_automatic_timestep``); ``'2d'`` limits the single dt by
        the 2D wave CFL as well; ``'3d'`` (default) uses the 3D bound with
        an implicit 2D solve.  dt is then fitted to the export interval
        and, for 'split', dt_2d refitted to divide dt."""
        o = self.options
        ts = str(o.timestepper_type)
        cfl2d_i, cfl3d_i = self._CFL_COEFFS.get(ts, (np.inf, 1.0))
        cfl2d = cfl2d_i * float(o.cfl_2d)
        cfl3d = cfl3d_i * float(o.cfl_3d)
        max_dt_swe = self.compute_dt_2d(o.horizontal_velocity_scale)
        max_dt_hadv = self.compute_dt_h_advection(o.horizontal_velocity_scale)
        max_dt_vadv = self.compute_dt_v_advection(o.vertical_velocity_scale)
        max_dt_diff = self.compute_dt_diffusion(o.horizontal_viscosity_scale)
        print_output(f"  - dt 2d swe: {max_dt_swe}")
        print_output(f"  - dt h. advection: {max_dt_hadv}")
        print_output(f"  - dt v. advection: {max_dt_vadv}")
        print_output(f"  - dt viscosity: {max_dt_diff}")
        max_dt_2d = cfl2d * max_dt_swe
        max_dt_3d = cfl3d * min(max_dt_hadv, max_dt_vadv, max_dt_diff)
        dt_mode = str(o.dt_mode)
        automatic = bool(o.use_automatic_timestep)
        if not automatic:
            if o.timestep is None or not o.timestep > 0:
                raise ValueError("options.timestep must be positive")
            self.dt = float(o.timestep)
        dt_2d = float(o.timestep_2d or 10.0)
        if dt_mode == "split":
            if automatic:
                self.dt = float(max_dt_3d)
                # the explicit 2D substep runs SSPRK33: its wave-CFL
                # bound governs dt_2d (cfl_2d is the user safety factor)
                dt_2d = float(self._SPLIT_2D_CFL * float(o.cfl_2d)
                              * max_dt_swe)
        elif dt_mode == "2d":
            if automatic:
                self.dt = float(min(max_dt_2d, max_dt_3d))
        elif automatic:  # '3d'
            self.dt = float(max_dt_3d)
        # fit dt to the export interval
        m_exp = max(1, int(np.ceil(o.simulation_export_time / self.dt)))
        self.dt = float(o.simulation_export_time) / m_exp
        if dt_mode == "split":
            self.M_modesplit = max(1, int(np.ceil(self.dt / dt_2d)))
            self.dt_2d = self.dt / self.M_modesplit
        else:
            self.M_modesplit = 1
            self.dt_2d = self.dt
        print_output(f"dt = {self.dt}")
        if dt_mode == "split":
            print_output(f"2D dt = {self.dt_2d} {self.M_modesplit}")
        return self.dt

    def initialize(self):
        self.create_equations()
        o = self.options
        if o.use_automatic_timestep or str(o.dt_mode) != "3d":
            self.set_time_step()
        else:
            self.dt = float(o.timestep)
            self.dt_2d = self.dt
            self.M_modesplit = 1
        # barotropic Krylov: 1e-5 relative residual, short restarts (the
        # mode-split wave CFL is O(1)); the semi-implicit system is affine
        # with 1-ring sparsity, so its exact blocks are assembled per step
        assembled = str(o.barotropic_preconditioner) in (
            "assembled_schur", "assembled")
        default_params = NewtonParameters(
            ksp_rtol=1e-5, ksp_max_it=48,
            gmres_restart=6 if assembled else 24)
        if self.M_modesplit > 1:
            # dt_mode='split': explicit SSPRK33 2D mode subcycled at dt_2d
            self.swe_stepper = get_stepper("SSPRK33", self.eq_sw, self.dt_2d)
        else:
            self.swe_stepper = CrankNicolson(
                self.eq_sw, self.dt, semi_implicit=True,
                solver_parameters=(o.barotropic_solver_parameters
                                   or default_params),
                assembled_solve=assembled)
        self._build_step()
        self.create_exporters()
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
    def _bnd3(self, which):
        """The 3D boundary values of ``bnd_functions[which]`` as tensors on
        the mesh's device, read once (the reference captures them when its
        step is built); a ``symm`` entry keeps its None."""
        return {int(m): {k: None if v is None else self._tensor(v)
                         for k, v in spec.items()}
                for m, spec in (self.bnd_functions.get(which) or {}).items()}

    def _build_step(self):
        o = self.options
        dt = self.dt
        asm3d = self.asm3d
        ext = self.extruded
        nz = ext.nz
        bathy_cell = self.bathy_cell
        eq_mom, eq_salt = self.eq_momentum, self.eq_salt
        swe_stepper = self.swe_stepper
        M_split = self.M_modesplit
        use_turb = o.use_turbulence
        use_turb_adv = use_turb and o.use_turbulence_advection
        gls = getattr(self, "gls", None)
        eq_tke = getattr(self, "eq_tke", None)
        eq_psi = getattr(self, "eq_psi", None)
        smag = getattr(self, "smagorinsky", None)
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
        quad_p, quad_rho = o.use_quadratic_pressure, o.use_quadratic_density
        use_ale = o.use_ale_moving_mesh
        modesplit = o.use_modesplit_2d
        ts_type = str(o.timestepper_type)
        two_stage = ts_type in ("SSPRK22", "TwoStageRK")
        leapfrog = ts_type == "LeapFrogAM3"
        sigma = ext.sigma

        def geometry(elev):
            if not use_ale:
                # fixed mesh: the 3D mesh stays at rest, the free surface
                # moves in the 2D system only
                elev = torch.zeros_like(elev)
            return asm3d.layer_geometry(ext.z_interfaces(bathy_cell, elev))

        def baroclinicity(state, geom):
            """density -> baroclinic head -> int_pg."""
            if quad_rho:
                rho_h = density_solver.solve_p2(
                    state["salt_3d"], state["temp_3d"], horizontal=quad_p)
            else:
                rho_h = density_solver.solve(state["salt_3d"],
                                             state["temp_3d"])
            int_pg = bhc.compute_int_pg(
                bhc.compute_head(rho_h, geom, quadratic=quad_p), geom)
            if ipg_scale is not None:
                int_pg = float(ipg_scale) * int_pg
            return int_pg

        # the uniform-field drift needs only the advective terms: the
        # diffusion of a constant vanishes
        adv_terms = frozenset(["HorizontalAdvectionTerm",
                               "VerticalAdvectionTerm"])
        # the packed tracer transport: every solved tracer plus the
        # uniform "ones" consistency field ride a trailing component axis
        # through ONE residual evaluation (sources excluded: they would
        # leak into the ones component)
        pack_terms = adv_terms | {"HorizontalDiffusionTerm",
                                  "VerticalDiffusionTerm"}

        def pack_residual(cp, fields3, geom):
            return eq_salt.residual(pack_terms, {"salt_3d": cp},
                                    {"salt_3d": cp}, fields3, fields3, {},
                                    geom=geom)["salt_3d"]

        bnd_mom = self._bnd3("momentum")
        tracer_bnds = {"salt_3d": self._bnd3("salt"),
                       "temp_3d": self._bnd3("temp")}
        # the packed path assumes the same (no) boundary values and no
        # source for every tracer; otherwise each tracer advances alone
        use_packed = not (any(tracer_bnds.values())
                          or o.temperature_source_3d is not None
                          or o.salinity_source_3d is not None)

        def ale_combine(eq, key, u0, u_eval, fields, geom0, geom_eval,
                        geom_new, a, b, consistency_fix=False, bnd=None):
            """Generalized ALE stage (SSPRK22 ALE):

                M_new u_new = a * M(geom0) u0
                            + b * (M(geom_eval) u_eval + dt R(u_eval))

            a=0, b=1 is the forward predictor stage; a=b=1/2 the SSPRK22
            averaging corrector.  With ``consistency_fix`` the drift of a
            uniform field is computed and subtracted, with no boundary
            value (a prescribed 'value' would leak into the drift)."""
            def raw(u0v, uev, label="all", bnd_r=bnd):
                r = eq.residual(label, {key: uev}, {key: uev}, fields,
                                fields, bnd_r, geom=geom_eval)
                acc = b * (eq.mass_term({key: uev}, geom_eval)[key]
                           + dt * r[key])
                if a != 0.0:
                    acc = acc + a * eq.mass_term({key: u0v}, geom0)[key]
                return eq.mass_inverse({key: acc}, geom_new)[key]

            out = raw(u0, u_eval)
            if consistency_fix:
                ones = torch.ones_like(u0)
                out = out - u0 * (raw(ones, ones, adv_terms, {}) - 1.0)
            return out

        # LeapFrogAM3 (ROMS' kernel): the predictor's weights
        lf_gamma = 1.0 / 12.0
        lf_a, lf_b = 0.5 - 2 * lf_gamma, 0.5 + 2 * lf_gamma
        lf_c = 1.0 - 2 * lf_gamma

        def lf_advance(eq, key, u0, u_prev, fields, geom_old, geom_new,
                       consistency_fix=False, bnd=None):
            """LeapFrogAM3 ALE step:

              predict (fixed mesh):
                u_half = (1/2 - 2g) u_{n-1} + (1/2 + 2g) u_n
                       + dt (1 - 2g) M0^-1 R(u_n)
              correct (Euler ALE):
                M_new u_{n+1} = M0 u_n + dt R(u_half)
            """
            def predict(u0v, upv, label="all", bnd_r=bnd):
                r = eq.residual(label, {key: u0v}, {key: u0v}, fields,
                                fields, bnd_r, geom=geom_old)
                k = eq.mass_inverse({key: r[key]}, geom_old)[key]
                return lf_a * upv + lf_b * u0v + dt * lf_c * k

            def correct(u0v, uhv, label="all", bnd_r=bnd):
                r = eq.residual(label, {key: uhv}, {key: uhv}, fields,
                                fields, bnd_r, geom=geom_old)
                m0 = eq.mass_term({key: u0v}, geom_old)[key]
                return eq.mass_inverse({key: m0 + dt * r[key]},
                                       geom_new)[key]

            u_half = predict(u0, u_prev)
            if consistency_fix:
                ones = torch.ones_like(u0)
                u_half = u_half - u0 * (predict(ones, ones, adv_terms, {})
                                        - 1.0)
            u1 = correct(u0, u_half)
            if consistency_fix:
                ones = torch.ones_like(u0)
                u1 = u1 - u0 * (correct(ones, ones, adv_terms, {}) - 1.0)
            return u1

        def ale_advance(eq, key, u0, fields, geom_old, geom_new,
                        consistency_fix=False, u_prev=None, limit=False,
                        bnd=None):
            """Advance one 3D field over the step: one forward ALE stage,
            the two SSPRK22 ALE stages, or LeapFrogAM3 from ``u_prev``;
            with ``limit`` the vertex limiter after every stage."""
            def lim(x):
                return limiter.apply(x) if limit else x

            if leapfrog:
                return lim(lf_advance(eq, key, u0, u_prev, fields, geom_old,
                                      geom_new, consistency_fix, bnd))
            u1 = lim(ale_combine(eq, key, u0, u0, fields, geom_old, geom_old,
                                 geom_new, 0.0, 1.0, consistency_fix, bnd))
            if not two_stage:
                return u1
            return lim(ale_combine(eq, key, u0, u1, fields, geom_old,
                                   geom_new, geom_new, 0.5, 0.5,
                                   consistency_fix, bnd))

        def pack_fix(cp_out, cp0, limit):
            """Post-stage packed consistency fix: subtract the uniform-field
            drift (last component - 1) from every tracer, limit each
            component, reset the ones carrier."""
            drift = cp_out[..., -1:] - 1.0
            tr = cp_out[..., :-1] - cp0[..., :-1] * drift
            if limit:
                tr = limiter.apply(tr)
            return torch.cat([tr, torch.ones_like(cp_out[..., -1:])], dim=-1)

        def pack_advance(cp0, fields3, geom_old, geom_new, u_prev=None,
                         limit=False):
            """Packed-tracer ALE advance: the stages of ``ale_advance``,
            with the drift from the ones component of the same residual
            pass."""
            if leapfrog:
                k = asm3d.mass_inverse(pack_residual(cp0, fields3, geom_old),
                                       geom_old)
                ch = pack_fix(lf_a * u_prev + lf_b * cp0 + dt * lf_c * k, cp0,
                              limit=False)
                m0 = asm3d.mass_apply(cp0, geom_old)
                c1 = asm3d.mass_inverse(
                    m0 + dt * pack_residual(ch, fields3, geom_old), geom_new)
                return pack_fix(c1, cp0, limit)

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
            sigma * d(eta)/dt; zero on a fixed mesh."""
            deta_dt = (elev_new - elev_old) / dt          # (nc, 3)
            if not use_ale:
                deta_dt = torch.zeros_like(deta_dt)
            wm_if = sigma * deta_dt[..., None]            # (nc, 3, nz+1)
            return torch.stack([wm_if[..., :-1], wm_if[..., 1:]], dim=-1)

        def pre(state):
            """Baroclinicity diagnostics feeding the 2D solve: returns
            ``(geom0, int_pg, src_2d)``, the 2D momentum source being the
            lagged split residual, or without mode splitting the
            depth-averaged internal pressure gradient (None without
            baroclinicity)."""
            geom0 = geometry(state["elev"])
            int_pg = (baroclinicity(state, geom0)
                      if o.use_baroclinic_formulation else None)
            if modesplit:
                return geom0, int_pg, state["split_residual"]
            if int_pg is None:
                return geom0, None, None
            return geom0, int_pg, asm3d.vertical_integral(int_pg, geom0,
                                                          average=True)

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
            # a 2D viscosity field enters the 3D momentum at its cell nodes
            visc_h = swe_fields.get("viscosity_h")
            vh_cells = swe_fields.get("viscosity_h_cells")
            if vh_cells is not None:
                visc_h = vh_cells[:, :, None, None].expand(
                    tuple(vh_cells.shape[:2]) + (nz, 2))
            if smag is not None:
                # the Smagorinsky closure adds to the background viscosity
                nu_smag = smag.solve(uv_total, geom0)
                visc_h = nu_smag if visc_h is None else nu_smag + visc_h
            fields3 = {
                "w_3d": w_adv,
                "w_mesh_3d": w_mesh,
                "int_pg_3d": int_pg,
                "coriolis": swe_fields.get("coriolis"),
                # Coriolis acts on the deviation in the 3D mode
                "coriolis_bg_uv_2d": sw["uv"],
                "viscosity_h": visc_h,
                "momentum_source_3d": swe_fields.get("momentum_source_3d"),
            }
            fields3 = {k: v for k, v in fields3.items() if v is not None}
            uv_new = ale_advance(eq_mom, "uv_3d", uv_total, fields3, geom0,
                                 geom, u_prev=state.get("uv_lf_old"),
                                 limit=o.use_limiter_for_velocity,
                                 bnd=bnd_mom)

            # tracers, advected by the continuity-consistent velocity
            tr_fields = {"uv_3d": uv_adv, "w_3d": w_adv, "w_mesh_3d": w_mesh,
                         "diffusivity_h": swe_fields.get("diffusivity_h"),
                         "diffusivity_v": mu_v0,
                         "source-temp_3d": swe_fields.get("source-temp_3d"),
                         "source-salt_3d": swe_fields.get("source-salt_3d")}
            tr_fields = {k: v for k, v in tr_fields.items() if v is not None}
            new_state = dict(state)
            if leapfrog:
                # the history is the total velocity
                new_state["uv_lf_old"] = uv_total
            tracer_keys = [k for k, on in (("salt_3d", solve_salt),
                                           ("temp_3d", solve_temp)) if on]
            if tracer_keys and use_packed:
                ones = torch.ones_like(state[tracer_keys[0]])
                cp0 = torch.stack([state[k] for k in tracer_keys] + [ones],
                                  dim=-1)
                prev = None
                if leapfrog:
                    prev = torch.stack([state[_lf_key(k)]
                                        for k in tracer_keys] + [ones],
                                       dim=-1)
                cp_new = pack_advance(cp0, tr_fields, geom0, geom,
                                      u_prev=prev,
                                      limit=o.use_limiter_for_tracers)
                for i, k in enumerate(tracer_keys):
                    new_state[k] = cp_new[..., i]
            else:
                # boundary values or sources differ between the tracers:
                # each advances alone
                eqs = {"salt_3d": eq_salt, "temp_3d": self.eq_temp}
                for k in tracer_keys:
                    new_state[k] = ale_advance(
                        eqs[k], k, state[k], tr_fields, geom0, geom,
                        consistency_fix=True,
                        u_prev=state.get(_lf_key(k)),
                        limit=o.use_limiter_for_tracers,
                        bnd=tracer_bnds[k])
            if leapfrog:
                for k in tracer_keys:
                    new_state[_lf_key(k)] = state[k]

            # implicit vertical mixing with the eddy coefficients of the
            # previous turbulence update plus the background, wind surface
            # stress and bottom friction
            Dn = geom["Delta_nodes"]
            if o.use_implicit_vertical_diffusion:
                if use_turb:
                    nu_col = state["nu_v_3d"] + nu_v0
                    mu_col = state["mu_v_3d"] + mu_v0
                else:
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

            # turbulence closure update on the *mixed* fields: shear and
            # buoyancy frequencies of the new velocity (depth average still
            # in) and the new tracers' density on the new geometry; the
            # closure takes the lagged coefficients without the background
            if use_turb:
                tke_in, psi_in = state["tke_3d"], state["psi_3d"]
                if use_turb_adv:
                    # advection of the turbulence quantities with the same
                    # continuity-consistent velocity as the tracers
                    turb_fields = {"uv_3d": uv_adv, "w_3d": w_adv,
                                   "w_mesh_3d": w_mesh}
                    tke_in = ale_advance(eq_tke, "tke_3d", tke_in,
                                         turb_fields, geom0, geom,
                                         u_prev=state.get("tke_lf_old"))
                    psi_in = ale_advance(eq_psi, "psi_3d", psi_in,
                                         turb_fields, geom0, geom,
                                         u_prev=state.get("psi_lf_old"))
                    if leapfrog:
                        new_state["tke_lf_old"] = state["tke_3d"]
                        new_state["psi_lf_old"] = state["psi_3d"]
                rho_new = density_solver.solve(new_state["salt_3d"],
                                               new_state["temp_3d"])
                m2, n2 = gls.compute_shear_buoy_freq(uv_new, rho_new, geom,
                                                     rho0=rho0)
                k_new, psi_new = gls.step_columns(
                    tke_in, psi_in, m2, n2, state["nu_v_3d"],
                    state["mu_v_3d"], Dn, dt)
                nu_v, mu_v, _, _ = gls.eddy_coefficients(k_new, psi_new,
                                                         m2, n2)
                new_state["tke_3d"] = k_new
                new_state["psi_3d"] = psi_new
                new_state["nu_v_3d"] = nu_v
                new_state["mu_v_3d"] = mu_v

            # 2D<->3D coupling: remove the depth average (the 2D solution
            # carries it); with mode splitting the removed average relative
            # to the 2D flow, over dt, is the next step's 2D momentum source
            uv_dav = asm3d.vertical_integral(uv_new, geom, average=True)
            new_state["uv_3d"] = uv_new - expand_function_to_3d(uv_dav, nz)
            if modesplit:
                new_state["split_residual"] = (uv_dav - sw["uv"]) / dt
            new_state["uv"] = sw["uv"]
            new_state["elev"] = sw["elev"]
            return new_state

        def step(state, swe_fields, bnd_sw):
            geom0, int_pg, src_2d = pre(state)
            user_src = swe_fields.get("momentum_source_user")
            if user_src is not None:
                src_2d = user_src if src_2d is None else src_2d + user_src
            if src_2d is not None:
                swe_fields = dict(swe_fields)
                swe_fields["momentum_source"] = src_2d
            sw = {"uv": state["uv"], "elev": state["elev"]}
            # dt_mode='split': M explicit barotropic substeps at dt_2d
            for _ in range(M_split):
                sw = swe_stepper.advance(0.0, sw, swe_fields, swe_fields,
                                         bnd_sw)
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
        """The step's state from the fields; under LeapFrogAM3 its
        history keys are seeded with the current state (the total
        velocity for ``uv_lf_old``), so the first step reduces to a
        forward stage."""
        o = self.options
        f = self.fields
        s = {
            "uv": f.uv_2d.data, "elev": f.elev_2d.data,
            "uv_3d": f.uv_3d.data,
            "salt_3d": f.salt_3d.data, "temp_3d": f.temp_3d.data,
            "tke_3d": f.tke_3d.data, "psi_3d": f.psi_3d.data,
        }
        if o.use_modesplit_2d:
            s["split_residual"] = f.split_residual_2d.data
        leapfrog = str(o.timestepper_type) == "LeapFrogAM3"
        if o.use_turbulence:
            s["nu_v_3d"] = f.nu_v_3d.data
            s["mu_v_3d"] = f.mu_v_3d.data
            if o.use_turbulence_advection and leapfrog:
                s["tke_lf_old"] = f.tke_3d.data
                s["psi_lf_old"] = f.psi_3d.data
        if leapfrog:
            s["uv_lf_old"] = f.uv_3d.data + expand_function_to_3d(
                f.uv_2d.data, self.extruded.nz)
            s["salt_lf_old"] = f.salt_3d.data
            s["temp_lf_old"] = f.temp_3d.data
        return s

    def _set_state(self, s):
        f = self.fields
        f.uv_2d.data = s["uv"]
        f.elev_2d.data = s["elev"]
        f.uv_3d.data = s["uv_3d"]
        # diagnostic vertical velocity from the total transport (export
        # quality; a function of the prognostic state alone)
        elev_mesh = (s["elev"] if self.options.use_ale_moving_mesh
                     else torch.zeros_like(s["elev"]))
        geom = self.asm3d.layer_geometry(
            self.extruded.z_interfaces(self.bathy_cell, elev_mesh))
        wsolve = (self.w_solver.solve_weak
                  if self.options.use_flux_consistent_w
                  else self.w_solver.solve)
        f.w_3d.data = wsolve(
            s["uv_3d"] + expand_function_to_3d(s["uv"], self.extruded.nz),
            geom)
        f.salt_3d.data = s["salt_3d"]
        f.temp_3d.data = s["temp_3d"]
        f.tke_3d.data = s["tke_3d"]
        f.psi_3d.data = s["psi_3d"]
        if "split_residual" in s:
            f.split_residual_2d.data = s["split_residual"]
        if "nu_v_3d" in s:
            f.nu_v_3d.data = s["nu_v_3d"]
            f.mu_v_3d.data = s["mu_v_3d"]

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
        v = o.horizontal_viscosity
        if isinstance(v, Function):
            out["viscosity_h"] = v.data
            # (nc, 3) cell nodes for the 3D momentum; CG1 is told from DG
            # by the space's family (their shapes agree where nc == nv)
            out["viscosity_h_cells"] = (
                v.data[mesh.cells] if v.function_space.family == "CG"
                else v.data)
        elif v is not None:
            out["viscosity_h"] = t(float(v))
        if o.horizontal_diffusivity is not None:
            out["diffusivity_h"] = t(float(o.horizontal_diffusivity))
        if o.volume_source_2d is not None:
            v = t(o.volume_source_2d)
            if v.dim() and v.shape[0] == mesh.nv:
                v = v[mesh.cells]
            out["volume_source"] = v
        # interior 3D sources, on the (nc, 3, nz, 2) dof layout
        for opt, key in (("momentum_source_3d", "momentum_source_3d"),
                         ("temperature_source_3d", "source-temp_3d"),
                         ("salinity_source_3d", "source-salt_3d")):
            if getattr(o, opt) is not None:
                out[key] = t(getattr(o, opt))
        if o.quadratic_drag_coefficient is not None and \
                not o.use_bottom_friction:
            # with 3D bottom friction the drag acts on the 3D momentum;
            # forwarding it to the 2D mode as well would count it twice
            out["quadratic_drag_coefficient"] = t(
                float(o.quadratic_drag_coefficient))
        return out

    def _gather_bnd_sw(self):
        """The 2D mode's boundary data as tensors on the mesh's device."""
        return self._bnd3("shallow_water")

    # -- monitors and the time loop --------------------------------------
    def _register_monitor_callbacks(self):
        """Attach the conservation/overshoot monitors the options ask for
        (evaluated at every export)."""
        o = self.options
        if o.check_volume_conservation_3d:
            self.add_callback(VolumeConservation3DCallback(self))
        for name, solve in (("salinity", o.solve_salinity),
                            ("temperature", o.solve_temperature)):
            field = "salt_3d" if name == "salinity" else "temp_3d"
            if getattr(o, f"check_{name}_conservation") and solve:
                self.add_callback(
                    TracerMassConservation3DCallback(field, self))
            if getattr(o, f"check_{name}_overshoot") and solve:
                self.add_callback(TracerOvershootCallBack(field, self))

    def iterate(self, update_forcings=None, export_func=None):
        """The time loop: to the end time, with the callbacks (and
        ``export_func``) at every export.  Without ``update_forcings`` a
        whole export interval runs as one :meth:`advance_n`; with it, the
        forcings are gathered again before every step."""
        if not self._initialized:
            self.initialize()
        if not self._monitors_registered:
            self._register_monitor_callbacks()
            self._monitors_registered = True
        o = self.options
        state = self._get_state()
        swe_fields = self._gather_swe_fields()
        bnd_sw = self._gather_bnd_sw()
        next_export = self.simulation_time + o.simulation_export_time
        self._print_state(state)
        if not self._initial_export_done:
            self.export()
            self._initial_export_done = True
        while self.simulation_time <= o.simulation_end_time - 1e-5:
            if update_forcings is None:
                n = max(1, int(round(
                    (min(next_export, o.simulation_end_time + self.dt)
                     - self.simulation_time) / self.dt)))
                with timed_stage("mode_split_step"):
                    state = self.advance_n(state, swe_fields, bnd_sw, n)
                self.iteration += n
                self.simulation_time += n * self.dt
            else:
                update_forcings(self.simulation_time + self.dt)
                swe_fields = self._gather_swe_fields()
                bnd_sw = self._gather_bnd_sw()
                with timed_stage("mode_split_step"):
                    state = self._step(state, swe_fields, bnd_sw)
                self.iteration += 1
                self.simulation_time += self.dt
            if self.simulation_time >= next_export - 1e-5:
                self.i_export += 1
                next_export += o.simulation_export_time
                self._set_state(state)
                self._print_state(state)
                with timed_stage("export"):
                    self.export()
                    if export_func is not None:
                        export_func()
        self._set_state(state)

    @staticmethod
    def _host(t):
        """A tensor as a float64 numpy array (the monitors sum on the host
        in double, whatever the model's dtype)."""
        return t.detach().cpu().numpy().astype(np.float64)

    def _column_depth_area(self):
        """Per cell, on the host: mean total depth H + eta and area."""
        elev = self._host(self.fields.elev_2d.data).mean(axis=1)
        h = self._host(self.bathy_cell).mean(axis=1)
        return h + elev, np.asarray(self.mesh2d.cell_area_np)

    def compute_volume_3d(self):
        """Total water volume sum(area * (H + eta)); read on the host
        (once per export)."""
        depth, area = self._column_depth_area()
        return float((depth * area).sum())

    def compute_tracer_mass_3d(self, name):
        """int tracer dV with sigma-layer weights."""
        tr = self._host(self.fields[name].data)            # (nc, 3, nz, 2)
        depth, area = self._column_depth_area()
        w = np.diff(self.extruded.sigma_np)                # (nz,) fractions
        col = (tr.mean(axis=(1, 3)) * w[None, :]).sum(axis=1)
        return float((col * depth * area).sum())

    def print_state_debug(self):
        """Min/max dump of every registered field."""
        for key in sorted(self.fields.keys()):
            d = self.fields[key].data
            print_output(f"{key:16s} {float(d.min()):14.6e} .. "
                         f"{float(d.max()):14.6e}")

    def _print_state(self, state):
        """One line of norms and ranges (host reads; once per export)."""
        asm = self.asm
        e = float(asm.norm_l2(state["elev"]))
        u2 = float(asm.norm_l2(state["uv"]))
        u3 = float(torch.sqrt((state["uv_3d"] ** 2).sum()))
        s_rng = (float(state["salt_3d"].min()), float(state["salt_3d"].max()))
        t_rng = (float(state["temp_3d"].min()), float(state["temp_3d"].max()))
        print_output(
            f"{self.i_export:5d} {self.iteration:5d} "
            f"T={self.simulation_time:10.2f} eta norm: {e:10.4f} "
            f"u norm: {u2:10.4f} u3 norm: {u3:10.4f} "
            f"salt: {s_rng[0]:.3f}..{s_rng[1]:.3f} "
            f"temp: {t_rng[0]:.3f}..{t_rng[1]:.3f}")
