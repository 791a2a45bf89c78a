"""Typed, frozen model options.

Mirrors the reference's traitlets option tree (``thetis/options.py``,
``thetis/configuration.py``): attribute names and defaults match
``ModelOptions2d``; classes are *frozen* after construction so typos raise
immediately (ref ``configuration.py:294-330``), and selecting a time stepper
swaps in the matching stepper-options object (the ``PairedEnum`` /
``attach_paired_options`` mechanism, ref ``configuration.py:231-368``).

Firedrake ``Constant``/``Function`` valued traits become plain python
scalars or dof arrays.

Copied unchanged from ``thetis_tpu/model/options.py`` (numpy / plain Python only).
"""

__all__ = [
    "FrozenOptions",
    "SedimentModelOptions",
    "TimeStepperOptions",
    "ModelOptions2d",
    "TracerFieldOptions",
]


class FrozenOptions:
    """Attribute-frozen options base (ref ``FrozenConfigurable``)."""

    _initialized = False

    def _freeze(self):
        object.__setattr__(self, "_initialized", True)

    def __setattr__(self, key, value):
        if self._initialized and not hasattr(self, key):
            raise AttributeError(
                f"{self.__class__.__name__} has no option '{key}'"
            )
        object.__setattr__(self, key, value)

    def update(self, other):
        items = other.items() if isinstance(other, dict) else vars(other).items()
        for k, v in items:
            if k.startswith("_"):
                continue
            setattr(self, k, v)

    def __str__(self):
        lines = [f"{self.__class__.__name__}:"]
        for k in sorted(vars(self)):
            if not k.startswith("_"):
                lines.append(f"  {k} = {getattr(self, k)!r}")
        return "\n".join(lines)


class TimeStepperOptions(FrozenOptions):
    """Per-stepper options (ref ``options.py:27-262`` family)."""

    def __init__(self, **kw):
        self.solver_parameters = {}
        self.ad_block_tag = None
        self.update(kw)
        self._freeze()


class SemiImplicitTimeStepperOptions2d(TimeStepperOptions):
    def __init__(self, **kw):
        self.use_semi_implicit_linearization = True
        #: None (auto: assembled wave-Schur for dg-dg SWE without
        #: wetting-and-drying, mass inverse otherwise), 'mass', 'schur',
        #: 'assembled_schur', or a prebuilt callable
        self.preconditioner = None
        super().__init__(**kw)


class CrankNicolsonTimeStepperOptions2d(SemiImplicitTimeStepperOptions2d):
    def __init__(self, **kw):
        self.implicitness_theta = 0.5
        self.use_semi_implicit_linearization = False
        super().__init__(**kw)


class ExplicitTimeStepperOptions2d(TimeStepperOptions):
    def __init__(self, **kw):
        self.use_automatic_timestep = True
        super().__init__(**kw)


class SteadyStateTimeStepperOptions2d(TimeStepperOptions):
    pass


class PressureProjectionTimeStepperOptions2d(TimeStepperOptions):
    def __init__(self, **kw):
        self.implicitness_theta = 0.5
        self.picard_iterations = 2
        super().__init__(**kw)


#: stepper name -> options class (the PairedEnum table of
#: ``options.py:838-865``)
STEPPER_OPTIONS_2D = {
    "SSPRK33": ExplicitTimeStepperOptions2d,
    "ForwardEuler": ExplicitTimeStepperOptions2d,
    "BackwardEuler": SemiImplicitTimeStepperOptions2d,
    "CrankNicolson": CrankNicolsonTimeStepperOptions2d,
    "DIRK22": SemiImplicitTimeStepperOptions2d,
    "DIRK33": SemiImplicitTimeStepperOptions2d,
    "SteadyState": SteadyStateTimeStepperOptions2d,
    "PressureProjectionPicard": PressureProjectionTimeStepperOptions2d,
    "SSPIMEX": SemiImplicitTimeStepperOptions2d,
}


class TracerFieldOptions(FrozenOptions):
    """Per-tracer configuration (ref ``options.py:459-520`` TracerOptions)."""

    def __init__(self, label, name=None, filename=None, shortname=None,
                 unit="", source=None, diffusivity=None,
                 use_conservative_form=False):
        self.label = label
        self.name = name or label
        self.filename = filename or label.replace("_", "")
        self.shortname = shortname or self.name
        self.unit = unit
        self.source = source
        self.diffusivity = diffusivity
        self.use_conservative_form = use_conservative_form
        self._freeze()


class SedimentModelOptions(FrozenOptions):
    """ref ``options.py:657-835`` SedimentModelOptions."""

    def __init__(self, **kw):
        self.solve_suspended_sediment = False
        self.use_sediment_conservative_form = False
        self.use_bedload = False
        self.use_exner = False
        self.use_sediment_slide = False
        self.use_angle_correction = True
        self.use_slope_mag_correction = True
        self.use_advective_velocity_correction = True
        self.use_secondary_current = False
        self.average_sediment_size = 2e-4
        self.bed_reference_height = 0.025
        self.sediment_density = 2650.0
        self.morphological_viscosity = None
        #: suspended-sediment horizontal diffusivity (ref
        #: SedimentModelOptions.horizontal_diffusivity)
        self.horizontal_diffusivity = None
        self.morphological_acceleration_factor = 1.0
        self.porosity = 0.4
        self.slope_effect_parameter = 1.3
        self.slope_effect_angle_parameter = 2.0 / 3.0
        self.secondary_current_parameter = 0.75
        self.max_angle = 32.0
        self.sed_slide_length_scale = 0.0
        self.slide_region = None
        self.sediment_model_class = None  # set to SedimentModel lazily
        self.sediment_timestepper_type = "CrankNicolson"
        self.exner_timestepper_type = "CrankNicolson"
        self.update(kw)
        self._freeze()


class NonhydrostaticModelOptions(FrozenOptions):
    """NH pressure sub-options (ref ``options.py:566-600``)."""

    def __init__(self):
        self.solve_nonhydrostatic_pressure = False
        self.update_free_surface = True
        self.free_surface_timestepper_type = "CrankNicolson"
        self.q_degree = 2
        self.q_solver_rtol = 1e-8
        self.q_solver_maxiter = 200
        self._freeze()


class ModelOptions2d(FrozenOptions):
    """2D model options (ref ``options.py:866-1041``)."""

    def __init__(self):
        # discretisation
        self.polynomial_degree = 1
        self.element_family = "dg-dg"
        self.tracer_element_family = "dg"
        self.use_nonlinear_equations = True
        self.use_grad_div_viscosity_term = False
        self.use_grad_depth_viscosity_term = True
        self.use_lax_friedrichs_velocity = True
        self.lax_friedrichs_velocity_scaling_factor = 1.0
        self.use_lax_friedrichs_tracer = False
        self.lax_friedrichs_tracer_scaling_factor = 1.0
        self.use_limiter_for_tracers = True
        self.use_supg_tracer = False
        # global default for tracer registration (ref ``options.py:870``
        # ``use_tracer_conservative_form``); per-tracer
        # ``use_conservative_form`` overrides it
        self.use_tracer_conservative_form = False
        # visualization output format: 'vtk' (ParaView .vtu/.pvd, the
        # reference's format) or 'npz'
        self.export_format = "vtk"
        self.sipg_factor = 1.0
        self.sipg_factor_tracer = 1.0
        # time stepping
        self.timestep = 10.0
        self.cfl_2d = 1.0
        self.simulation_export_time = 100.0
        self.simulation_end_time = 1000.0
        self.simulation_initial_date = None
        self.simulation_end_date = None
        # wetting and drying
        self.use_wetting_and_drying = False
        self.wetting_and_drying_alpha = 0.5
        self.use_automatic_wetting_and_drying_alpha = False
        self.wetting_and_drying_alpha_min = None
        self.wetting_and_drying_alpha_max = 10.0
        self.norm_smoother = 0.0
        # physics coefficients (None = term disabled)
        self.linear_drag_coefficient = None
        self.quadratic_drag_coefficient = None
        self.manning_drag_coefficient = None
        self.nikuradse_bed_roughness = None
        self.horizontal_viscosity = None
        self.horizontal_diffusivity = None
        self.coriolis_frequency = None
        self.wind_stress = None
        self.atmospheric_pressure = None
        self.momentum_source_2d = None
        self.volume_source_2d = None
        self.tracer_advective_velocity_factor = 1.0
        self.horizontal_velocity_scale = 0.1
        self.horizontal_viscosity_scale = 1.0
        self.horizontal_diffusivity_scale = 1.0
        # turbines
        self.tidal_turbine_farms = {}
        self.discrete_tidal_turbine_farms = {}
        # I/O
        self.output_directory = "outputs"
        self.no_exports = False
        self.export_diagnostics = True
        self.fields_to_export = ["elev_2d", "uv_2d"]
        self.fields_to_export_hdf5 = []
        self.log_output = True
        self.verbose = 0
        # monitoring
        self.check_volume_conservation_2d = False
        self.check_tracer_conservation = False
        self.check_tracer_overshoot = False
        # tracers (label -> TracerFieldOptions); populated by add_tracer_2d
        self.tracer = {}
        self.tracer_only = False
        self.tracer_picard_iterations = 1
        # sediment / NH sub-option objects
        self.sediment_model_options = SedimentModelOptions()
        self.nh_model_options = NonhydrostaticModelOptions()
        # steppers (paired-enum behaviour in __setattr__)
        self.swe_timestepper_type = "CrankNicolson"
        self.swe_timestepper_options = CrankNicolsonTimeStepperOptions2d()
        self.tracer_timestepper_type = "CrankNicolson"
        self.tracer_timestepper_options = CrankNicolsonTimeStepperOptions2d()
        self.sediment_timestepper_type = "CrankNicolson"
        self.sediment_timestepper_options = CrankNicolsonTimeStepperOptions2d()
        self.exner_timestepper_type = "CrankNicolson"
        self.exner_timestepper_options = CrankNicolsonTimeStepperOptions2d()
        self._freeze()

    def __setattr__(self, key, value):
        super().__setattr__(key, value)
        # paired-enum: swap the matching options object when a stepper type
        # changes (ref configuration.py:333-368)
        if self._initialized and key.endswith("_timestepper_type"):
            prefix = key[: -len("_type")]
            cls = STEPPER_OPTIONS_2D.get(value)
            if cls is None:
                raise ValueError(f"unknown time stepper '{value}'")
            object.__setattr__(self, prefix + "_options", cls())

    def add_tracer_2d(self, label, name=None, filename=None, shortname=None,
                      unit="", source=None, diffusivity=None,
                      use_conservative_form=None):
        """Register a passive tracer (ref ``options.py:951-988``).
        ``use_conservative_form=None`` inherits the model-level
        ``use_tracer_conservative_form`` trait (ref ``options.py:870``)."""
        if use_conservative_form is None:
            use_conservative_form = bool(
                getattr(self, "use_tracer_conservative_form", False))
        self.tracer[label] = TracerFieldOptions(
            label, name=name, filename=filename, shortname=shortname,
            unit=unit, source=source, diffusivity=diffusivity,
            use_conservative_form=use_conservative_form,
        )

    def add_tracer_system_2d(self, labels, names=None, filenames=None,
                             shortnames=None, units=None, sources=None,
                             diffusivities=None, use_conservative_form=None):
        """Register a coupled system of tracers (ref ``options.py:990-1025``)."""
        n = len(labels)
        for i, label in enumerate(labels):
            self.add_tracer_2d(
                label,
                name=(names or [None] * n)[i],
                filename=(filenames or [None] * n)[i],
                shortname=(shortnames or [None] * n)[i],
                unit=(units or [""] * n)[i],
                source=(sources or [None] * n)[i],
                diffusivity=(diffusivities or [None] * n)[i],
                use_conservative_form=use_conservative_form,
            )
