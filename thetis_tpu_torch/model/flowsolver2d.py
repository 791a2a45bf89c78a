"""FlowSolver2d — the user-facing 2D model object (port of
``thetis_tpu/model/flowsolver2d.py``, the ``dg-dg`` family).

Mirrors the reference's ``thetis/solver2d.py`` lifecycle and API:
``__init__(mesh2d, bathymetry_2d)`` -> set ``.options`` ->
``assign_initial_conditions`` -> ``iterate(update_forcings, export_func)``,
with ``create_function_spaces/fields/equations/timestepper`` stages,
``bnd_functions`` weak-BC dicts and the volume-conservation callback.

Every tensor lives on ``mesh2d.device`` in ``mesh2d.dtype``.  The
reference's jitted advance and its ``lax.scan`` over an export interval
are a Python loop over the stepper's ``advance`` here; the export cadence
and the iteration counters follow the reference exactly.

Time steppers: SSPRK33, ForwardEuler, CrankNicolson and BackwardEuler.
The implicit SWE solve is set up as in the reference: the semi-implicit
CN assembles the exact step system every step and solves it with
block-Jacobi FGMRES, with the setup-time coarse correction or Schur
fieldsplit chosen by the implicit wave CFL (:meth:`_build_coarse`); the
Newton CN (``use_semi_implicit_linearization = False``) is preconditioned
by the setup-time ``AssembledWavePC`` (:meth:`_swe_preconditioner`).
(The CN options class sets that switch to False and its parent class
then sets it to True, so the CN a user gets by default is the
semi-implicit one, in the reference as here.)  On a CUDA mesh every
9x9 ring matvec and block-Jacobi apply of these solves is a hand-written
kernel (``kernels/ringmv.py``).

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
item: tracers, sediment, Exner, the non-hydrostatic pressure, tidal
turbines, wetting-and-drying, the ``dg-cg``/``rt-dg``/``bdm-dg`` families
and the DIRK/IMEX/PressureProjectionPicard/SteadyState steppers (A8);
``differentiable_forward`` (A9); exporters (``no_exports=False``), the
diagnostic HDF5 series and ``load_state`` (A10).
"""
import time as time_mod

import numpy as np
import torch

from ..config import physical_constants
from ..equations.shallowwater_2d import ShallowWaterEquations
from ..fem.assembly import DGAssembler
from ..fem.functionspace import Function, FunctionSpace
from ..solvers.newton import NewtonParameters
from ..timeintegration.steppers import _UNPORTED, get_stepper
from ..utils.constant import Constant
from ..utils.log import print_output
from .callback import CallbackManager, VolumeConservation2DCallback
from .field_defs import FieldDict
from .options import ModelOptions2d

__all__ = ["FlowSolver2d"]


def _unported(what, item="A8"):
    return NotImplementedError(
        f"{what} is not ported to thetis_tpu_torch yet (ROADMAP {item})")


class FlowSolver2d:
    """ref ``solver2d.py:28-1144``."""

    def __init__(self, mesh2d, bathymetry_2d, options=None):
        self._initialized = False
        self.mesh2d = mesh2d
        self.bathymetry_dof = (
            bathymetry_2d.data if isinstance(bathymetry_2d, Function)
            else self._tensor(bathymetry_2d)
        )
        self._bathymetry_input = bathymetry_2d
        self.options = ModelOptions2d()
        if options is not None:
            self.options.update(options)
        self.dt = None
        self.simulation_time = 0.0
        self.iteration = 0
        self.i_export = 0
        self.next_export_t = 0.0
        self.callbacks = CallbackManager()
        self.bnd_functions = {"shallow_water": {}, "tracer": {},
                              "sediment": {}}
        self._functions_created = False
        self._equations_created = False
        self._timestepper_created = False
        self._exporters_created = False
        self._initial_export_done = False
        self.export_initial_state = True

    # ------------------------------------------------------------------
    def _tensor(self, v):
        """A value as a tensor on the mesh's device, in its dtype."""
        return torch.as_tensor(np.asarray(v) if isinstance(v, Constant)
                               else v, dtype=self.mesh2d.dtype,
                               device=self.mesh2d.device)

    def _value(self, v):
        """Current tensor value of a Constant / Function / tensor /
        array / scalar (the reference's ``_value``)."""
        if v is None:
            return None
        if isinstance(v, Function):
            return v.data
        if callable(v) and not isinstance(v, Constant):
            raise TypeError("callable coefficients must be wrapped in Function")
        return self._tensor(v)

    def _check_options(self):
        """Raise for every option whose code path is not ported."""
        o = self.options
        family = o.element_family
        if family in ("dg-cg", "rt-dg", "bdm-dg"):
            raise _unported(f"the {family} element family")
        if family != "dg-dg":
            raise ValueError(f"unknown element family {family!r}")
        if getattr(self.mesh2d, "geometric_dimension", 2) == 3:
            raise _unported("manifold (sphere) meshes")
        so = o.sediment_model_options
        nho = o.nh_model_options
        checks = [
            (len(o.tracer) > 0 or o.tracer_only, "2D tracers"),
            (so is not None and so.solve_suspended_sediment,
             "suspended sediment"),
            (so is not None and so.use_exner, "the Exner bed evolution"),
            (nho is not None and nho.solve_nonhydrostatic_pressure,
             "the non-hydrostatic pressure"),
            (bool(o.tidal_turbine_farms or o.discrete_tidal_turbine_farms),
             "tidal turbine farms"),
            (o.use_wetting_and_drying, "wetting-and-drying"),
            (o.swe_timestepper_type in _UNPORTED,
             f"the {o.swe_timestepper_type} time stepper"),
        ]
        for bad, what in checks:
            if bad:
                raise _unported(what)

    # ------------------------------------------------------------------
    def create_function_spaces(self):
        """ref ``solver2d.py:307-352``; the dg-dg family."""
        self._check_options()
        mesh = self.mesh2d
        p = self.options.polynomial_degree
        self.function_spaces = type("FS", (), {})()
        fs = self.function_spaces
        fs.P0_2d = FunctionSpace(mesh, "DG", 0)
        fs.P1_2d = FunctionSpace(mesh, "CG", 1)
        fs.P1DG_2d = FunctionSpace(mesh, "DG", 1)
        fs.U_2d = FunctionSpace(mesh, "DG", p, dim=2)
        fs.H_2d = FunctionSpace(mesh, "DG", p)
        self.asm = DGAssembler(mesh, FunctionSpace(mesh, "DG", p))
        self._functions_created = False

    def create_fields(self):
        if not hasattr(self, "function_spaces"):
            self.create_function_spaces()
        fs = self.function_spaces
        self.fields = FieldDict()
        f = self.fields
        f.bathymetry_2d = Function(fs.P1_2d, name="Bathymetry")
        # accept CG1 / DG dof layouts
        b = self.bathymetry_dof
        if b.dim() == 0:
            f.bathymetry_2d.data = b.expand(self.mesh2d.nv).clone()
        elif tuple(b.shape) == (self.mesh2d.nv,):
            f.bathymetry_2d.data = b
        else:
            f.bathymetry_2d = Function(fs.H_2d, name="Bathymetry", data=b)
        f.elev_2d = Function(fs.H_2d, name="elev_2d")
        f.uv_2d = Function(fs.U_2d, name="uv_2d")
        self.tracer_labels = []
        self.solve_tracer = False
        self.solve_nh = False
        self.solve_sediment = False
        self.solve_exner = False
        self._functions_created = True

    def create_equations(self):
        self._check_options()
        if not self._functions_created:
            self.create_fields()
        self.tidal_farms = []
        self.eq_sw = ShallowWaterEquations(
            self.mesh2d, self.asm, self.options,
            bathymetry=self.fields.bathymetry_2d.data,
            bnd_conditions=self.bnd_functions["shallow_water"],
            tidal_farms=self.tidal_farms,
        )
        self.depth = self.eq_sw.depth
        self.sediment_model = None
        self._equations_created = True

    def _assembled_eligible(self, choice):
        """The assembled-Jacobian KSP / assembled wave PC require P1DG
        cell blocks (dg-dg family) and a linear (no wetting-and-drying
        displacement) mass term."""
        o = self.options
        if choice is not None and choice != "assembled":
            return False
        return (
            o.element_family == "dg-dg"
            and not o.use_wetting_and_drying
            and getattr(self.asm, "ndofs", None) == 3
        )

    def _wave_cfl(self, coeff):
        """Rest-state implicit wave CFL ``sqrt(g H_max) coeff / h_min``."""
        g = float(physical_constants["g_grav"])
        h_max = float(self.bathymetry_dof.max())
        return (np.sqrt(g * max(h_max, 0.05)) * coeff
                / float(np.asarray(self.mesh2d.cell_hmin_np).min()))

    def _build_coarse(self, coeff):
        """Setup-time preconditioner for the assembled implicit-SWE KSP,
        chosen by the rest-state implicit wave CFL (the reference's policy
        and thresholds, unchanged):

        * CFL < 4: none (plain block-Jacobi FGMRES);
        * CFL < 8: the Galerkin coarse correction
          (:class:`~..solvers.assembled.CoarseCorrection`) as a two-level
          V-cycle, on per-field aggregate constants (eta, u, v); the
          reference's per-packed-dof coarse space stalls FGMRES here
          (ROADMAP C);
        * larger: the Schur fieldsplit PC
          (:class:`~..solvers.fieldsplit.SchurFieldsplitPC`).

        The operator's blocks are probed only when a coarse PC is built
        (the reference probes them in every case)."""
        from ..solvers.assembled import (
            CoarseCorrection, PackedState, assemble_affine_operator,
            get_coloring)
        from ..solvers.fieldsplit import SchurFieldsplitPC

        cfl = self._wave_cfl(coeff)
        if cfl < 4.0:
            return None
        eq = self.eq_sw
        zero = {"uv": torch.zeros_like(self.fields.uv_2d.data),
                "elev": torch.zeros_like(self.fields.elev_2d.data)}
        ps = PackedState(zero)
        bnd_zero = {m: {k: 0.0 for k in keys}
                    for m, keys in getattr(eq, "bnd_keys", {}).items()}

        def F(x):
            st = ps.unpack(x)
            r = eq.residual("all", st, zero, {}, {}, bnd_zero)
            m = eq.mass_term(st)
            return ps.pack({"uv": m["uv"] - coeff * r["uv"],
                            "elev": m["elev"] - coeff * r["elev"]})

        blocks, _ = assemble_affine_operator(F, ps.pack(zero), eq.mesh,
                                             chunk_size=9)
        ring, _, _ = get_coloring(eq.mesh)
        if cfl < 8.0:
            # packed [elev (3), u/v interleaved (6)] -> fields eta, u, v
            return CoarseCorrection(blocks, ring, eq.mesh,
                                    fields=[0, 0, 0, 1, 2, 1, 2, 1, 2])
        return SchurFieldsplitPC(blocks, ring, eq.mesh)

    def _swe_preconditioner(self, choice, theta):
        """Resolve the implicit-SWE preconditioner choice: auto (None)
        builds the setup-time assembled wave PC for the plain dg-dg family
        without wetting-and-drying; otherwise the exact mass inverse."""
        if callable(choice):
            return choice
        if choice is None:
            choice = ("assembled_schur" if self._assembled_eligible(None)
                      else "mass")
        if choice in ("assembled_schur", "assembled"):
            from ..solvers.assembled import AssembledWavePC

            zero = {"uv": torch.zeros_like(self.fields.uv_2d.data),
                    "elev": torch.zeros_like(self.fields.elev_2d.data)}
            # the inner GMRES budget scales with the implicit wave CFL
            cfl = self._wave_cfl(theta * self.dt)
            n_inner = int(np.clip(2.0 * cfl, 10, 60))
            return AssembledWavePC(self.eq_sw, self.dt, theta, zero,
                                   inner_iterations=n_inner)
        return str(choice)

    def create_timestepper(self):
        """ref ``solver2d.py:651-702``."""
        if not self._equations_created:
            self.create_equations()
        self._check_options()
        self.set_time_step()
        o = self.options
        sp = o.swe_timestepper_options
        kw = {}
        name = o.swe_timestepper_type
        if name in ("CrankNicolson", "BackwardEuler"):
            kw["semi_implicit"] = bool(
                getattr(sp, "use_semi_implicit_linearization", False))
            spp = getattr(sp, "solver_parameters", None)
            if name == "CrankNicolson":
                kw["theta"] = float(getattr(sp, "implicitness_theta", 0.5))
            choice = getattr(sp, "preconditioner", None)
            if kw["semi_implicit"] and self._assembled_eligible(choice):
                # semi-implicit SWE systems are affine + 1-ring local:
                # assemble the exact per-step Jacobian and run the whole
                # KSP on it, two-level preconditioned (coarse built once
                # at setup)
                kw["assembled_solve"] = True
                coeff = (kw["theta"] * self.dt if name == "CrankNicolson"
                         else self.dt)
                kw["coarse"] = self._build_coarse(coeff)
            else:
                kw["preconditioner"] = self._swe_preconditioner(
                    choice, theta=kw.get("theta", 1.0))
            if isinstance(spp, NewtonParameters):
                kw["solver_parameters"] = spp
            elif kw.get("assembled_solve"):
                # assembled matvecs are cheap: afford a long restart
                kw["solver_parameters"] = NewtonParameters(
                    ksp_rtol=1e-7, ksp_max_it=96, gmres_restart=24)
            elif callable(kw.get("preconditioner")):
                # strong (assembled wave) PC: few outer iterations, so a
                # short FGMRES restart avoids paying unused Arnoldi steps
                kw["solver_parameters"] = NewtonParameters(
                    ksp_max_it=24, gmres_restart=8)
            else:
                kw["solver_parameters"] = NewtonParameters()
        self.timestepper = get_stepper(name, self.eq_sw, self.dt, o, **kw)
        self._build_advance()
        self._timestepper_created = True

    def create_exporters(self):
        """ref ``solver2d.py:704-730``: the VTK/HDF5 exporters are not
        ported; a run must set ``options.no_exports = True``."""
        if not self.options.no_exports:
            raise _unported("field exporters (options.no_exports=False)",
                            "A10")
        self.exporters = {}
        self._exporters_created = True

    def initialize(self):
        if not self._functions_created:
            self.create_fields()
        if not self._equations_created:
            self.create_equations()
        if not self._timestepper_created:
            self.create_timestepper()
        if not self._exporters_created:
            self.create_exporters()
        self._initialized = True

    # ------------------------------------------------------------------
    def compute_time_step(self, u_scale=0.0):
        """Max explicit dt from CFL: dt = dx / (sqrt(g H) + U)
        (ref ``solver2d.py:149-176``); host numpy, per cell."""
        g = physical_constants["g_grav"]
        mesh = self.mesh2d
        b = self.fields.bathymetry_2d.data.detach().cpu().numpy()
        if b.shape[:1] == (mesh.nv,):
            H_cell = b[mesh.cells_np].mean(axis=1)
        elif b.ndim >= 2:
            H_cell = b.mean(axis=1)
        else:
            H_cell = np.full(mesh.nc, float(b))
        H_cell = np.maximum(H_cell, 0.05)
        u = np.sqrt(g * H_cell) + float(u_scale)
        return mesh.cell_hmin_np / u

    def set_time_step(self, alpha=0.05):
        """ref ``solver2d.py:215-248``."""
        o = self.options
        automatic = getattr(o.swe_timestepper_options,
                            "use_automatic_timestep", False)
        if automatic:
            dts = self.compute_time_step(
                u_scale=float(o.horizontal_velocity_scale))
            self.dt = float(o.cfl_2d * alpha * dts.min())
        else:
            if o.timestep is None or not o.timestep > 0:
                raise ValueError("options.timestep must be positive")
            self.dt = float(o.timestep)
        print_output(f"dt = {self.dt}")

    # ------------------------------------------------------------------
    def _gather_swe_fields(self):
        o = self.options
        f = {}
        pairs = [
            ("coriolis_frequency", "coriolis"),
            ("horizontal_viscosity", "viscosity_h"),
            ("wind_stress", "wind_stress"),
            ("atmospheric_pressure", "atmospheric_pressure"),
            ("quadratic_drag_coefficient", "quadratic_drag_coefficient"),
            ("manning_drag_coefficient", "manning_drag_coefficient"),
            ("nikuradse_bed_roughness", "nikuradse_bed_roughness"),
            ("linear_drag_coefficient", "linear_drag_coefficient"),
            ("momentum_source_2d", "momentum_source"),
            ("volume_source_2d", "volume_source"),
        ]
        for opt_key, eq_key in pairs:
            v = getattr(o, opt_key)
            if v is not None:
                f[eq_key] = self._value(v)
        f["lax_friedrichs_velocity_scaling_factor"] = self._value(
            o.lax_friedrichs_velocity_scaling_factor)
        return f

    def _gather_bnd(self, which):
        return {int(marker): {k: self._value(v) for k, v in spec.items()}
                for marker, spec in self.bnd_functions[which].items()}

    # ------------------------------------------------------------------
    def _build_advance(self):
        """The coupled advance (SWE only in the port)."""
        swe_stepper = self.timestepper

        def advance(t, state, swe_fields, tracer_extra, bnd_sw, bnd_tr):
            sw = swe_stepper.advance(
                t, {"uv": state["uv"], "elev": state["elev"]},
                swe_fields, swe_fields, bnd_sw)
            new_state = dict(state)
            new_state["uv"] = sw["uv"]
            new_state["elev"] = sw["elev"]
            return new_state

        def advance_n(state, t0, dt, n, swe_fields, tracer_extra, bnd_sw,
                      bnd_tr):
            """``n`` steps in a Python loop (the reference's scan)."""
            t = t0
            for _ in range(int(n)):
                state = advance(t, state, swe_fields, tracer_extra, bnd_sw,
                                bnd_tr)
                t = t + dt
            return state

        self._advance = advance
        self._advance_n = advance_n

    def _get_state(self):
        return {"uv": self.fields.uv_2d.data,
                "elev": self.fields.elev_2d.data}

    def _set_state(self, s):
        self.fields.uv_2d.data = s["uv"]
        self.fields.elev_2d.data = s["elev"]

    # ------------------------------------------------------------------
    def differentiable_forward(self, *args, **kwargs):
        raise _unported("differentiable_forward (the adjoint)", "A9")

    def load_state(self, *args, **kwargs):
        raise _unported("load_state (HDF5 checkpoints)", "A10")

    # ------------------------------------------------------------------
    def assign_initial_conditions(self, elev=None, uv=None, **tracers):
        """ref ``solver2d.py:747-783``; tracer keywords have no field in
        the port and are ignored, as the reference ignores unknown
        labels."""
        if not self._initialized:
            self.initialize()
        if elev is not None:
            self.fields.elev_2d.data = self._interp_to(
                self.function_spaces.H_2d, elev)
        if uv is not None:
            self.fields.uv_2d.data = self._interp_to(
                self.function_spaces.U_2d, uv)

    def _interp_to(self, space, value):
        shape = space.dof_shape()
        if isinstance(value, Function):
            src = value
            if src.function_space is space:
                return src.data
            if src.function_space.family == "CG" and space.family == "DG":
                # gather CG values at DG nodes (vertex-collocated for P1)
                cd = src.function_space.cell_dofs(src.data)
                if space.dim > 1 and cd.dim() == 2:
                    cd = torch.stack([cd] * space.dim, dim=-1)
                return cd
            return torch.broadcast_to(src.data, shape).contiguous()
        value = self._tensor(value)
        if tuple(value.shape) == tuple(shape):
            return value
        # CG1 vertex data (scalar or vector) -> DG nodes via the cell map
        if tuple(value.shape[:1]) == (self.mesh2d.nv,):
            return value[self.mesh2d.cells]
        return torch.broadcast_to(value, shape).contiguous()

    # ------------------------------------------------------------------
    def add_callback(self, callback, eval_interval="export"):
        self.callbacks.add(callback, eval_interval)

    def compute_volume_2d(self):
        eta = self.fields.elev_2d.data
        return (float(self.asm.integrate(eta))
                + float(self.asm.integrate_cellq(self.eq_sw.bathy_q)))

    def create_iterator(self, update_forcings=None, export_func=None):
        """Generator stepping the model one time step per ``next()``,
        yielding the simulation time after each step and handling exports
        (ref ``solver2d.py:997-1076``)."""
        if not self._initialized:
            self.initialize()
        o = self.options
        state = self._get_state()
        self.next_export_t = self.simulation_time + o.simulation_export_time
        if not self._initial_export_done:
            self._initial_export_done = True
            self.print_state(0.0)
            if not o.no_exports:
                self.export()
            if export_func is not None:
                export_func()
        t_epsilon = 1e-5
        while self.simulation_time <= o.simulation_end_time - t_epsilon:
            if update_forcings is not None:
                update_forcings(self.simulation_time + self.dt)
            swe_fields = self._gather_swe_fields()
            bnd_sw = self._gather_bnd("shallow_water")
            state = self._advance(self.simulation_time, state, swe_fields,
                                  {}, bnd_sw, {})
            self.iteration += 1
            self.simulation_time += self.dt
            self._set_state(state)
            self.callbacks.evaluate(mode="timestep")
            if self.simulation_time >= self.next_export_t - t_epsilon:
                self.i_export += 1
                self.next_export_t += o.simulation_export_time
                self.print_state(0.0)
                if not o.no_exports:
                    self.export()
                if export_func is not None:
                    export_func()
            yield self.simulation_time

    def print_state_debug(self):
        """Min/max dump of every registered field (ref
        ``solver.py:1193-1214``)."""
        for key in sorted(self.fields.keys()):
            d = self.fields[key].data
            print_output(f"{key:16s} {float(d.min()):14.6e} .. "
                         f"{float(d.max()):14.6e}")

    def print_state(self, cputime, print_header=False):
        """ref ``solver2d.py:923-971``."""
        norm_eta = float(self.asm.norm_l2(self.fields.elev_2d.data))
        norm_uv = float(self.asm.norm_l2(self.fields.uv_2d.data))
        line = (
            "{iexp:5d} {i:5d} T={t:10.2f} eta norm: {e:10.4f} "
            "u norm: {u:10.4f} {cpu:5.2f}"
        )
        print_output(line.format(
            iexp=self.i_export, i=self.iteration, t=self.simulation_time,
            e=norm_eta, u=norm_uv, cpu=cputime))

    # ------------------------------------------------------------------
    def export(self):
        self.callbacks.evaluate(mode="export")
        for e in self.exporters.values():
            e.export(time=self.simulation_time, iteration=self.iteration)

    def _resolve_end_date(self):
        """``simulation_end_date`` (+ ``simulation_initial_date``) wins
        over ``simulation_end_time`` (ref ``solver2d.py:1086-1103``)."""
        o = self.options
        init_date, end_date = o.simulation_initial_date, o.simulation_end_date
        if init_date is None or end_date is None:
            return
        import datetime

        now = init_date + datetime.timedelta(seconds=self.simulation_time)
        if not end_date > now:
            raise ValueError(
                f"simulation end date must be greater than initial time "
                f"{now}")
        if o.simulation_end_time is not None:
            print_output(
                "WARNING: both simulation_end_date and simulation_end_time "
                "set; ignoring simulation_end_time")
        o.simulation_end_time = ((end_date - now).total_seconds()
                                 + self.simulation_time)

    def iterate(self, update_forcings=None, export_func=None):
        """Main time loop (ref ``solver2d.py:974-1144``)."""
        from ..utils.profiling import timed_stage

        if not self._initialized:
            self.initialize()
        o = self.options
        self._resolve_end_date()
        # auto-attach the conservation callback (ref L1040-1085)
        if o.check_volume_conservation_2d:
            self.add_callback(VolumeConservation2DCallback(self))

        t_epsilon = 1e-5
        self.next_export_t = self.simulation_time + o.simulation_export_time
        state = self._get_state()

        if not self._initial_export_done:
            self.print_state(0.0)
            if not o.no_exports:
                self.export()
            self._initial_export_done = True

        has_timestep_callbacks = len(self.callbacks.get("timestep", {})) > 0
        use_scan = update_forcings is None and not has_timestep_callbacks
        cpu_t0 = time_mod.perf_counter()

        while self.simulation_time <= o.simulation_end_time - t_epsilon:
            swe_fields = self._gather_swe_fields()
            bnd_sw = self._gather_bnd("shallow_water")
            if use_scan:
                # the reference scans to the next export; a Python loop
                t_target = min(self.next_export_t, o.simulation_end_time)
                n = max(1, int(round((t_target - self.simulation_time)
                                     / self.dt)))
                with timed_stage("coupled_advance"):
                    state = self._advance_n(state, self.simulation_time,
                                            self.dt, n, swe_fields, {},
                                            bnd_sw, {})
                self.iteration += n
                self.simulation_time += n * self.dt
            else:
                if update_forcings is not None:
                    update_forcings(self.simulation_time + self.dt)
                    swe_fields = self._gather_swe_fields()
                    bnd_sw = self._gather_bnd("shallow_water")
                with timed_stage("coupled_advance"):
                    state = self._advance(self.simulation_time, state,
                                          swe_fields, {}, bnd_sw, {})
                self.iteration += 1
                self.simulation_time += self.dt
                self._set_state(state)
                self.callbacks.evaluate(mode="timestep")

            if self.simulation_time >= self.next_export_t - t_epsilon:
                self._set_state(state)
                self.i_export += 1
                self.next_export_t += o.simulation_export_time
                cpu = time_mod.perf_counter() - cpu_t0
                cpu_t0 = time_mod.perf_counter()
                self.print_state(cpu)
                if not o.no_exports:
                    self.export()
                if export_func is not None:
                    export_func()
        self._set_state(state)
