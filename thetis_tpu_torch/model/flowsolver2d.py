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

Time steppers: every one of the reference's ``get_stepper``.  The
implicit SWE solve is set up as in the reference: the semi-implicit CN,
BackwardEuler and DIRK22/DIRK33 assemble the exact step (stage) system
and solve it with block-Jacobi FGMRES, with the setup-time coarse
correction or Schur fieldsplit chosen by the implicit wave CFL
(:meth:`_build_coarse`; a DIRK's from its diagonal a_ii dt); the Newton
CN (``use_semi_implicit_linearization = False``) is preconditioned by
the setup-time ``AssembledWavePC`` (:meth:`_swe_preconditioner`).
(The CN options class sets that switch to False and its parent class
then sets it to True, so the CN a user gets by default is the
semi-implicit one, in the reference as here.)  On a CUDA mesh every
9x9 ring matvec and block-Jacobi apply of these solves is a hand-written
kernel (``kernels/ringmv.py``).  Wetting-and-drying (constant or
automatic alpha) keeps the SWE off the assembled path, as in the
reference: its solves are the matrix-free Newton ones.

Each step advances, in the reference's order: the SWE (its bed the
Exner-evolved one when ``use_exner``), then under
``solve_nonhydrostatic_pressure`` the NH Poisson solve, the uv/w update
and the free-surface corrector, then the 2D tracers (DG or CG1, one or
several, with the vertex-based limiter, sources, callable reaction
sources and the tracer Picard sweeps), the suspended sediment (with the
limiter) and the Exner bed; ``tracer_only`` skips the SWE.  Continuous
and discrete tidal turbine farms add their drag to the SWE.

Element families (``options.element_family``): ``dg-dg``; ``dg-cg``
(P1DG velocity x P2 CG elevation, ``equations/shallowwater_dgcg.py``);
``rt-dg`` and ``bdm-dg``, the H(div) velocities with DG elevation: RT1 /
BDM1 x P0 at ``polynomial_degree = 0`` (``equations/shallowwater_rtdg.py``),
RT2 / BDM2 x P1DG at 1, the reference's default, on planar meshes
(``equations/shallowwater_rt2.py``).  A
:class:`~thetis_tpu_torch.mesh.sphere.SphereMesh` takes the p = 0 H(div)
pairs, on a namespace of quadrature tabulations in place of the planar
``DGAssembler``.  The H(div) families run the plain SWE (no tracers,
sediment, NH or farms), as in the reference; none of these families is
on the assembled (ring-kernel) path.

``differentiable_forward`` builds the adjoint's forward model
(:mod:`thetis_tpu_torch.adjoint`).  Exports (``no_exports=False``) write
the VTK (or NPZ) series of ``fields_to_export`` and the HDF5 checkpoints
that ``load_state`` restarts from (``model/exporter.py``); with
``export_diagnostics`` the monitors write their HDF5 series.  One
departure from the reference: after ``load_state`` the restored state is
not exported again, so the series goes on at the uninterrupted run's
indices (the reference's 2D restart writes it once more, one index on).
"""
import time as time_mod
from types import SimpleNamespace

import numpy as np
import torch

from ..config import physical_constants
from ..equations.exner import ExnerEquation
from ..equations.limiter import VertexBasedP1DGLimiter
from ..equations.nh import DepthIntegratedPoissonSolver, FreeSurfaceEquation2D
from ..equations.sediment_2d import SedimentEquation2D
from ..equations.shallowwater_2d import ShallowWaterEquations
from ..equations.shallowwater_dgcg import ShallowWaterEquationsDGCG
from ..equations.shallowwater_rt2 import ShallowWaterEquationsRT2DG
from ..equations.shallowwater_rtdg import ShallowWaterEquationsRTDG
from ..equations.tracer_2d import TracerEquation2D, TracerEquation2DCG
from ..fem.assembly import DGAssembler
from ..fem.bdm import BDMSpace
from ..fem.bdm2 import BDM2Space
from ..fem.functionspace import Function, FunctionSpace
from ..fem.reference_element import ELEMENTS
from ..fem.rt import RTSpace
from ..fem.rt2 import NodalHdivSpace, RT2Space
from ..solvers.newton import NewtonParameters
from ..timeintegration.rungekutta import SCHEMES
from ..timeintegration.steppers import CrankNicolson, get_stepper
from ..utils.constant import Constant
from ..utils.log import print_output, set_log_directory
from .callback import (CallbackManager, TracerMassConservation2DCallback,
                       TracerOvershootCallBack, VolumeConservation2DCallback)
from .exporter import load_checkpoint, solver_exporters
from .field_defs import FieldDict, field_metadata
from .options import ModelOptions2d
from .sediment_model import SedimentModel
from .turbines import DiscreteTidalTurbineFarm, TidalTurbineFarm

__all__ = ["FlowSolver2d"]


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
        """The reference's checks of the element family (ref
        ``solver2d.py:307-352``)."""
        o = self.options
        family = o.element_family
        if family not in ("dg-dg", "dg-cg", "rt-dg", "bdm-dg"):
            raise ValueError(f"unknown element family {family!r}")
        manifold = getattr(self.mesh2d, "geometric_dimension", 2) == 3
        if manifold and family not in ("rt-dg", "bdm-dg"):
            raise ValueError("manifold (sphere) meshes require an H(div) "
                             "element family (ref solver2d.py:314-318)")
        p = o.polynomial_degree
        if family in ("rt-dg", "bdm-dg") and not (
                p == 0 or (p == 1 and not manifold)):
            raise ValueError(
                f"{family} implements p = 0 (H(div) x P0) and, on planar "
                "meshes, p = 1 (RT2/BDM2 x P1DG): set "
                "options.polynomial_degree accordingly")

    # ------------------------------------------------------------------
    def create_function_spaces(self):
        """ref ``solver2d.py:307-352``: the dg-dg, dg-cg, rt-dg and
        bdm-dg families."""
        self._check_options()
        mesh = self.mesh2d
        family = self.options.element_family
        p = self.options.polynomial_degree
        self.function_spaces = type("FS", (), {})()
        fs = self.function_spaces
        fs.P0_2d = FunctionSpace(mesh, "DG", 0)
        fs.P1_2d = FunctionSpace(mesh, "CG", 1)
        fs.P1DG_2d = FunctionSpace(mesh, "DG", 1)
        if family in ("rt-dg", "bdm-dg") and p == 1:
            # RT2/BDM2 x P1DG (ref solver2d.py:329-336 builds U =
            # RT/BDM(p+1), H = DG(p)); the basis products are quartic:
            # degree-5 quadrature
            fs.H_2d = FunctionSpace(mesh, "DG", 1, quad_degree=5)
            self.asm = DGAssembler(mesh, fs.H_2d)
            fs.U_2d = (RT2Space if family == "rt-dg" else BDM2Space)(
                mesh, self.asm)
        elif family in ("rt-dg", "bdm-dg"):
            if getattr(mesh, "geometric_dimension", 2) == 3:
                # a sphere has no global planar chart, so the planar
                # DGAssembler cannot be built; the H(div) spaces and the
                # RTDG equations only read its quadrature tabulations
                self.asm = SimpleNamespace(space=SimpleNamespace(
                    _tab_np=ELEMENTS[("DG", 1)].tabulate(3)))
            else:
                self.asm = DGAssembler(mesh, FunctionSpace(mesh, "DG", 1))
            fs.U_2d = (RTSpace if family == "rt-dg" else BDMSpace)(
                mesh, self.asm)
            fs.H_2d = FunctionSpace(mesh, "DG", 0)
        else:
            fs.U_2d = FunctionSpace(mesh, "DG", p, dim=2)
            # dg-cg: P1DG velocity x P2 CG elevation (ref
            # solver2d.py:318-321); the assembly context is the degree-p
            # DG space, the CG elevation has its own tabulations
            fs.H_2d = (FunctionSpace(mesh, "CG", p + 1)
                       if family == "dg-cg" else FunctionSpace(mesh, "DG", p))
            self.asm = DGAssembler(mesh, FunctionSpace(mesh, "DG", p))
        fs.Q_2d = (fs.P1_2d if self.options.tracer_element_family == "cg"
                   else fs.P1DG_2d)
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
        self.tracer_labels = list(self.options.tracer.keys())
        for label in self.tracer_labels:
            if label not in field_metadata:
                meta = self.options.tracer[label]
                field_metadata[label] = dict(
                    name=meta.name, shortname=meta.shortname, unit=meta.unit,
                    filename=meta.filename)
            f[label] = Function(fs.Q_2d, name=label)
        self.solve_tracer = len(self.tracer_labels) > 0
        nho = self.options.nh_model_options
        self.solve_nh = bool(nho and nho.solve_nonhydrostatic_pressure)
        if self.solve_nh:
            # the NH pressure q (moved to the Poisson solver's space in
            # create_equations) and the depth-averaged vertical velocity w
            # (ref solver2d.py:443-449)
            f.q_2d = Function(fs.P1_2d, name="q_2d")
            f.w_2d = Function(fs.H_2d, name="w_2d")
        so = self.options.sediment_model_options
        self.solve_sediment = bool(so and so.solve_suspended_sediment)
        self.solve_exner = bool(so and so.use_exner)
        if self.solve_sediment:
            f.sediment_2d = Function(fs.Q_2d, name="sediment_2d")
        self._functions_created = True

    def set_wetting_and_drying_alpha(self):
        """Automatic wetting-drying alpha ~ |L_x grad(h)| capped to
        [alpha_min, alpha_max] (ref ``solver2d.py:251-303``); host numpy,
        the result a P1 field."""
        o = self.options
        if not o.use_wetting_and_drying:
            return
        if not o.use_automatic_wetting_and_drying_alpha:
            print_output("Using constant wetting and drying parameter "
                         f"(value {float(o.wetting_and_drying_alpha):.2f})")
            return
        mesh = self.mesh2d
        b = self.fields.bathymetry_2d.data.detach().cpu().numpy()
        cells = mesh.cells_np
        if b.ndim == 0:
            bv = np.full((mesh.nc, 3), float(b))
        elif b.shape[:1] == (mesh.nv,):
            bv = b[cells]  # CG1 -> (nc, 3)
        elif b.shape[:2] == (mesh.nc, 3):
            bv = b[:, :, 0] if b.ndim == 3 else b
        else:
            raise ValueError("cannot derive automatic alpha from bathymetry "
                             f"of shape {b.shape}")
        # grad = Jinv^T @ dphi^T b, dphi rows [-1,-1],[1,0],[0,1]
        gref = np.stack([bv[:, 1] - bv[:, 0], bv[:, 2] - bv[:, 0]], axis=1)
        grad = np.einsum("cj,cji->ci", gref, mesh.Jinv_np)
        p = mesh.coords_np[cells]
        widths = p.max(axis=1) - p.min(axis=1)  # (nc, 2) x/y extents
        alpha_cell = (widths * np.abs(grad)).sum(axis=1)
        if o.wetting_and_drying_alpha_max is not None:
            alpha_cell = np.minimum(alpha_cell,
                                    float(o.wetting_and_drying_alpha_max))
        if o.wetting_and_drying_alpha_min is not None:
            alpha_cell = np.maximum(alpha_cell,
                                    float(o.wetting_and_drying_alpha_min))
        # P1 vertex values: max over the adjacent cells
        alpha_v = np.zeros(mesh.nv)
        np.maximum.at(alpha_v, cells.ravel(), np.repeat(alpha_cell, 3))
        o.wetting_and_drying_alpha = Function(
            self.function_spaces.P1_2d, name="wd_alpha",
            data=self._tensor(alpha_v))
        print_output("Using spatially varying wetting and drying parameter "
                     f"(min {alpha_v.min():.2f} max {alpha_v.max():.2f})")

    def create_equations(self):
        if not self._functions_created:
            self.create_fields()
        o = self.options
        self.set_wetting_and_drying_alpha()
        bathy = self.fields.bathymetry_2d.data
        hdiv = o.element_family in ("rt-dg", "bdm-dg")
        if hdiv and (o.tidal_turbine_farms or o.discrete_tidal_turbine_farms):
            raise ValueError("tidal farms are not implemented for the H(div) "
                             "families")
        if hdiv and (self.solve_nh or self.solve_tracer or self.solve_sediment
                     or self.solve_exner):
            raise ValueError("rt-dg/bdm-dg currently support the plain "
                             "shallow-water system")
        # tidal turbine farms (ref solver2d.py:462-485)
        def farms(by_subdomain):
            for subdomain, farm_opts in (by_subdomain or {}).items():
                mask = self._subdomain_mask(subdomain)
                for fo in (farm_opts if isinstance(farm_opts, (list, tuple))
                           else [farm_opts]):
                    yield fo, mask

        self.tidal_farms = (
            [TidalTurbineFarm(self.asm, self._value(fo.turbine_density), fo,
                              cell_mask=mask)
             for fo, mask in farms(o.tidal_turbine_farms)]
            + [DiscreteTidalTurbineFarm(self.asm, fo, cell_mask=mask)
               for fo, mask in farms(o.discrete_tidal_turbine_farms)])
        bnd = self.bnd_functions["shallow_water"]
        if o.element_family == "dg-cg":
            self.eq_sw = ShallowWaterEquationsDGCG(
                self.mesh2d, self.asm, self.function_spaces.H_2d, o,
                bathymetry=bathy, bnd_conditions=bnd,
                tidal_farms=self.tidal_farms)
        elif hdiv:
            U_2d = self.function_spaces.U_2d
            cls = (ShallowWaterEquationsRT2DG
                   if isinstance(U_2d, NodalHdivSpace)
                   else ShallowWaterEquationsRTDG)
            self.eq_sw = cls(self.mesh2d, self.asm, U_2d, o,
                             bathymetry=bathy, bnd_conditions=bnd)
        else:
            self.eq_sw = ShallowWaterEquations(
                self.mesh2d, self.asm, o, bathymetry=bathy,
                bnd_conditions=bnd, tidal_farms=self.tidal_farms)
        self.depth = getattr(self.eq_sw, "depth", None)
        if self.solve_nh:
            nho = o.nh_model_options
            if bathy.dim() != 1:
                raise ValueError("the NH pressure solver requires a CG1 "
                                 "bathymetry")
            self.poisson_solver = DepthIntegratedPoissonSolver(
                self.mesh2d, self.asm, self.depth, float(o.timestep),
                bnd_conditions=self.bnd_functions["shallow_water"],
                rtol=float(nho.q_solver_rtol),
                maxiter=int(nho.q_solver_maxiter),
                q_degree=int(nho.q_degree))
            # q_2d's dofs follow the Poisson space (CG P2 by default)
            self.fields.q_2d = Function(self.poisson_solver.q_space,
                                        name="q_2d")
            self.eq_free_surface = FreeSurfaceEquation2D(
                self.mesh2d, self.asm, self.depth, bathy,
                bnd_conditions=self.bnd_functions["shallow_water"])
        if self.solve_tracer:
            tracer_cls = (TracerEquation2DCG
                          if o.tracer_element_family == "cg"
                          else TracerEquation2D)
            self.eq_tracer = tracer_cls(
                self.mesh2d, self.asm, o, bathymetry=bathy,
                labels=self.tracer_labels,
                bnd_conditions=self.bnd_functions["tracer"],
                depth=self.depth)
        if self.solve_tracer or self.solve_sediment:
            self.tracer_limiter = (
                VertexBasedP1DGLimiter(self.function_spaces.Q_2d)
                if o.use_limiter_for_tracers
                and o.tracer_element_family != "cg" else None)
        # sediment and Exner (ref solver2d.py:507-524)
        self.sediment_model = None
        if self.solve_sediment or self.solve_exner:
            so = o.sediment_model_options
            cls = so.sediment_model_class or SedimentModel
            self.sediment_model = cls(o, self.mesh2d, depth=self.depth)
            if self.solve_sediment:
                self.eq_sediment = SedimentEquation2D(
                    self.mesh2d, self.asm, o, bathymetry=bathy,
                    sediment_model=self.sediment_model,
                    bnd_conditions=self.bnd_functions["sediment"],
                    depth=self.depth,
                    conservative=so.use_sediment_conservative_form)
            if self.solve_exner:
                self.eq_exner = ExnerEquation(
                    self.mesh2d, self.asm, self.function_spaces.P1_2d,
                    self.depth, self.sediment_model, o,
                    bnd_conditions=self.bnd_functions["shallow_water"],
                    depth_integrated_sediment=(
                        so.use_sediment_conservative_form))
        self._equations_created = True

    def _subdomain_mask(self, subdomain):
        """Cell mask of a subdomain id (ref ``solver2d.py:1087-1098``):
        None for 'everywhere', else from the mesh's per-cell markers
        ``cell_markers_np``."""
        if subdomain in ("everywhere", None):
            return None
        markers = getattr(self.mesh2d, "cell_markers_np", None)
        if markers is None:
            raise ValueError("mesh has no cell markers; cannot restrict to "
                             f"subdomain {subdomain}")
        return (np.asarray(markers) == int(subdomain)).astype(float)

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
        self.set_time_step()
        o = self.options
        sp = o.swe_timestepper_options
        kw = {}
        name = o.swe_timestepper_type
        if name in ("CrankNicolson", "BackwardEuler", "DIRK22", "DIRK33"):
            kw["semi_implicit"] = bool(
                getattr(sp, "use_semi_implicit_linearization", False))
            spp = getattr(sp, "solver_parameters", None)
            if name == "CrankNicolson":
                kw["theta"] = float(getattr(sp, "implicitness_theta", 0.5))
            choice = getattr(sp, "preconditioner", None)
            if kw["semi_implicit"] and self._assembled_eligible(choice):
                # semi-implicit SWE systems are affine + 1-ring local:
                # assemble the exact per-step (stage) Jacobian and run the
                # whole KSP on it, two-level preconditioned (coarse built
                # once at setup)
                kw["assembled_solve"] = True
                if name == "CrankNicolson":
                    coeff = kw["theta"] * self.dt
                elif name == "BackwardEuler":
                    coeff = self.dt
                else:  # stiffly accurate DIRK: constant diagonal a_ii
                    coeff = float(SCHEMES[name]().a[-1][-1]) * self.dt
                kw["coarse"] = self._build_coarse(coeff)
            elif name in ("CrankNicolson", "BackwardEuler"):
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
        spp = getattr(sp, "solver_parameters", None)
        if name == "SteadyState" and isinstance(spp, NewtonParameters):
            kw["solver_parameters"] = spp
        if name == "PressureProjectionPicard":
            kw["theta"] = float(getattr(sp, "implicitness_theta", 0.5))
            kw["picard_iterations"] = int(getattr(sp, "picard_iterations",
                                                  2))
            if isinstance(spp, NewtonParameters):
                kw["solver_parameters"] = spp
        self.timestepper = get_stepper(name, self.eq_sw, self.dt, o, **kw)
        if self.solve_tracer:
            tname = o.tracer_timestepper_type
            tso = o.tracer_timestepper_options
            tkw = {}
            if tname in ("CrankNicolson", "BackwardEuler", "DIRK22",
                         "DIRK33"):
                tkw["semi_implicit"] = bool(getattr(
                    tso, "use_semi_implicit_linearization", False))
                if tname == "CrankNicolson":
                    tkw["theta"] = float(getattr(tso, "implicitness_theta",
                                                 0.5))
            self.tracer_stepper = get_stepper(tname, self.eq_tracer,
                                              self.dt, o, **tkw)
        # sediment, Exner and the NH free surface (ref solver2d.py:595-615)
        so = o.sediment_model_options

        def semi(name):
            return ({"semi_implicit": True}
                    if name in ("CrankNicolson", "BackwardEuler") else {})

        if self.solve_sediment:
            self.sediment_stepper = get_stepper(
                so.sediment_timestepper_type, self.eq_sediment, self.dt, o,
                **semi(so.sediment_timestepper_type))
        if self.solve_exner:
            self.exner_stepper = get_stepper(
                so.exner_timestepper_type, self.eq_exner, self.dt, o,
                **semi(so.exner_timestepper_type))
        if self.solve_nh:
            nho = o.nh_model_options
            self.fs_stepper = (get_stepper(
                nho.free_surface_timestepper_type, self.eq_free_surface,
                self.dt, o, semi_implicit=True)
                if nho.update_free_surface else None)
        self._build_advance()
        self._timestepper_created = True

    def _checkpoint_field_keys(self):
        """Every prognostic field of a bit-exact restart (ref
        ``solver2d.py:874-921``)."""
        keys = ["elev_2d", "uv_2d"] + list(self.tracer_labels)
        if self.solve_sediment:
            keys.append("sediment_2d")
        if self.solve_exner:
            keys.append("bathymetry_2d")
        if self.solve_nh:
            keys += ["q_2d", "w_2d"]
        return keys

    def create_exporters(self):
        """The visualization series and the HDF5 checkpoints (ref
        ``solver2d.py:704-730``; :func:`.exporter.solver_exporters`)."""
        self.exporters = solver_exporters(self.options, self.fields,
                                          self._checkpoint_field_keys())
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

    def _gather_tracer_fields(self, state):
        """The tracer equation's fields (ref ``solver2d.py:715-738``);
        callable (state-dependent reaction) sources are evaluated in the
        advance, at the current Picard iterate."""
        o = self.options
        f = {
            "uv_2d": state["uv"],
            "elev_2d": state["elev"],
            "lax_friedrichs_tracer_scaling_factor": self._value(
                o.lax_friedrichs_tracer_scaling_factor),
            "tracer_advective_velocity_factor": self._value(
                o.tracer_advective_velocity_factor),
        }
        for label, topt in o.tracer.items():
            if topt.diffusivity is not None:
                f[f"diffusivity_h-{label}"] = self._value(topt.diffusivity)
            elif o.horizontal_diffusivity is not None:
                f[f"diffusivity_h-{label}"] = self._value(
                    o.horizontal_diffusivity)
            if topt.source is not None and not callable(topt.source):
                f[f"source-{label}"] = self._value(topt.source)
        return f

    def _gather_tracer_extra(self, state):
        """The tracer fields without the flow state (the advance adds
        the new one)."""
        if not self.solve_tracer:
            return {}
        f = self._gather_tracer_fields(state)
        f.pop("uv_2d")
        f.pop("elev_2d")
        return f

    def _add_sediment_diffusivity(self, tracer_extra):
        """The sediment's diffusivity (its own option before the global
        one, ref ``solver2d.py:899-907``) in the tracer fields."""
        if not self.solve_sediment:
            return tracer_extra
        so = self.options.sediment_model_options
        diff = so.horizontal_diffusivity or self.options.horizontal_diffusivity
        if diff is not None:
            tracer_extra["diffusivity_h-sediment_2d"] = self._value(diff)
        return tracer_extra

    def _gather_bnd(self, which):
        return {int(marker): {k: self._value(v) for k, v in spec.items()}
                for marker, spec in self.bnd_functions[which].items()}

    # ------------------------------------------------------------------
    def _build_advance(self):
        """The coupled advance (ref ``solver2d.py:746-907``,
        ``coupled_timeintegrator_2d.py:93-135``): SWE (on the state's bed
        under Exner), the NH pressure and free-surface corrector, the
        tracers with their Picard sweeps (each sweep followed by the
        limiter), the sediment (and the limiter), the Exner bed."""
        swe_stepper = self.timestepper
        solve_tracer = self.solve_tracer
        tracer_stepper = getattr(self, "tracer_stepper", None)
        limiter = getattr(self, "tracer_limiter", None)
        labels = self.tracer_labels
        tracer_only = self.options.tracer_only
        tracer_picard = int(getattr(self.options, "tracer_picard_iterations",
                                    1) or 1)
        callable_sources = {l: topt.source
                            for l, topt in self.options.tracer.items()
                            if callable(topt.source)}
        if (tracer_picard > 1 and solve_tracer
                and not isinstance(tracer_stepper, CrankNicolson)):
            raise NotImplementedError(
                "tracer_picard_iterations > 1 requires a CrankNicolson"
                "-family tracer timestepper (ref "
                "coupled_timeintegrator_2d.py:115-135)")

        solve_sediment = self.solve_sediment
        solve_exner = self.solve_exner
        sediment_stepper = getattr(self, "sediment_stepper", None)
        exner_stepper = getattr(self, "exner_stepper", None)
        sediment_model = self.sediment_model
        depth = self.depth
        cells = self.mesh2d.cells
        nv = self.mesh2d.nv
        static_bathy = self.fields.bathymetry_2d.data
        bnd_sed = self._gather_bnd("sediment") if solve_sediment else {}
        solve_nh = self.solve_nh
        poisson = getattr(self, "poisson_solver", None)
        fs_stepper = getattr(self, "fs_stepper", None)

        def advance(t, state, swe_fields, tracer_extra, bnd_sw, bnd_tr):
            sw = {"uv": state["uv"], "elev": state["elev"]}
            if solve_exner:
                swe_fields = dict(swe_fields)
                swe_fields["bathymetry_2d"] = state["bathymetry"]
            if not tracer_only:
                sw = swe_stepper.advance(t, sw, swe_fields, swe_fields,
                                         bnd_sw)
            new_state = dict(state)
            new_state["uv"] = sw["uv"]
            new_state["elev"] = sw["elev"]
            if solve_nh:
                # the serial NH advance (ref coupled_timeintegrator_2d.py:
                # 205-219): Poisson solve, velocity update, free-surface
                # corrector from the pre-step elevation with the mid-point
                # velocity
                q, uv_c, w_c = poisson.solve(sw["uv"], state["w"],
                                             sw["elev"], static_bathy,
                                             q0=state["q"])
                new_state["q"] = q
                new_state["w"] = w_c
                new_state["uv"] = uv_c
                if fs_stepper is not None:
                    ff = {"uv_2d": 0.5 * (state["uv"] + uv_c)}
                    new_state["elev"] = fs_stepper.advance(
                        t, {"elev": state["elev"]}, ff, ff, bnd_sw)["elev"]
            if solve_tracer:
                tf = dict(tracer_extra)
                tf["uv_2d"] = new_state["uv"]
                tf["elev_2d"] = new_state["elev"]
                tr0 = {l: state[l] for l in labels}
                tr = tr0
                # Picard sweeps re-linearize the semi-implicit solve at
                # the previous iterate and re-evaluate state-dependent
                # sources with it
                for i in range(tracer_picard):
                    tf_i = tf
                    if callable_sources:
                        tf_i = dict(tf)
                        for l, fn in callable_sources.items():
                            tf_i[f"source-{l}"] = fn(tr)
                    tr = tracer_stepper.advance(
                        t, tr0, tf_i, tf_i, bnd_tr,
                        **({"linearization_state": tr} if i > 0 else {}))
                    if limiter is not None:
                        tr = {l: limiter.apply(cl) for l, cl in tr.items()}
                for l in labels:
                    new_state[l] = tr[l]
            if solve_sediment:
                sf = {"uv_2d": new_state["uv"], "elev_2d": new_state["elev"],
                      "lax_friedrichs_tracer_scaling_factor":
                          tracer_extra.get(
                              "lax_friedrichs_tracer_scaling_factor", 1.0)}
                if solve_exner:
                    sf["bathymetry_2d"] = state["bathymetry"]
                diff = tracer_extra.get("diffusivity_h-sediment_2d")
                if diff is not None:
                    sf["diffusivity_h-sediment_2d"] = diff
                if sediment_model.use_advective_velocity_correction:
                    # the factor at the P1DG dof points (the reference's
                    # Function product)
                    b = state["bathymetry"] if solve_exner else static_bathy
                    b_dof = (b[cells] if b.dim() == 1 and b.shape[0] == nv
                             else b)
                    H_dof = depth.total_depth(b_dof, new_state["elev"])
                    sf["tracer_advective_velocity_factor"] = (
                        sediment_model
                        .get_advective_velocity_correction_factor(
                            new_state["uv"], H_dof))
                sed = sediment_stepper.advance(
                    t, {"sediment_2d": state["sediment_2d"]}, sf, sf,
                    bnd_sed)["sediment_2d"]
                if limiter is not None:
                    sed = limiter.apply(sed)
                new_state["sediment_2d"] = sed
            if solve_exner:
                ef = {"uv_2d": new_state["uv"], "elev_2d": new_state["elev"],
                      "sediment": new_state.get("sediment_2d")}
                new_state["bathymetry"] = exner_stepper.advance(
                    t, {"bathymetry": state["bathymetry"]}, ef, ef,
                    {})["bathymetry"]
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
        """ref ``solver2d.py:908-931``."""
        f = self.fields
        s = {"uv": f.uv_2d.data, "elev": f.elev_2d.data}
        for l in self.tracer_labels:
            s[l] = f[l].data
        if self.solve_sediment:
            s["sediment_2d"] = f.sediment_2d.data
        if self.solve_exner:
            s["bathymetry"] = f.bathymetry_2d.data
        if self.solve_nh:
            s["q"] = f.q_2d.data
            s["w"] = f.w_2d.data
        return s

    def _set_state(self, s):
        f = self.fields
        f.uv_2d.data = s["uv"]
        f.elev_2d.data = s["elev"]
        for l in self.tracer_labels:
            f[l].data = s[l]
        if self.solve_sediment:
            f.sediment_2d.data = s["sediment_2d"]
        if self.solve_exner:
            f.bathymetry_2d.data = s["bathymetry"]
        if self.solve_nh:
            f.q_2d.data = s["q"]
            f.w_2d.data = s["w"]

    # ------------------------------------------------------------------
    def differentiable_forward(self, controls, terminal_functional=None,
                               step_functional=None, n_steps=None,
                               checkpoint=None):
        """A differentiable forward model ``fn(*control_tensors) -> J``
        (a scalar tensor) for :mod:`thetis_tpu_torch.adjoint` (ref
        ``flowsolver2d.py:936-1026``): ``n_steps`` advances from the
        current state, through the same advance as :meth:`iterate`.

        :arg controls: list of control names: any SWE coefficient option
            ('quadratic_drag_coefficient', 'manning_drag_coefficient',
            'linear_drag_coefficient', 'horizontal_viscosity',
            'coriolis_frequency', 'wind_stress', 'momentum_source_2d',
            ...), 'turbine_density_{i}', 'initial_elev' or 'initial_uv'
        :arg terminal_functional: callable ``f(state) -> scalar`` on the
            final state dict
        :arg step_functional: callable ``f(state, fields, t) -> scalar``
            accumulated as ``sum_i f(...) * dt`` (``t`` the step's start)
        :kwarg checkpoint: adjoint memory checkpointing.  ``False`` keeps
            every step's activations; ``True`` or an int chunk size runs
            the sqrt-N schedule
            (:func:`~thetis_tpu_torch.adjoint.checkpointing.checkpointed_scan`,
            one extra forward per backward); the default ``None`` turns
            it on beyond 128 steps.

        The implicit solves differentiate by their implicit-function
        adjoints (``solvers/``), so the gradient is the reference's."""
        if not self._initialized:
            self.initialize()
        o = self.options
        n = n_steps or int(round(o.simulation_end_time / self.dt))
        state0 = dict(self._get_state())
        base_fields = self._gather_swe_fields()
        tracer_extra = self._gather_tracer_extra(state0)
        bnd_sw = self._gather_bnd("shallow_water")
        bnd_tr = self._gather_bnd("tracer")
        name_map = {
            "bathymetry_2d": "bathymetry_2d",
            "coriolis_frequency": "coriolis",
            "horizontal_viscosity": "viscosity_h",
            "wind_stress": "wind_stress",
            "atmospheric_pressure": "atmospheric_pressure",
            "quadratic_drag_coefficient": "quadratic_drag_coefficient",
            "manning_drag_coefficient": "manning_drag_coefficient",
            "nikuradse_bed_roughness": "nikuradse_bed_roughness",
            "linear_drag_coefficient": "linear_drag_coefficient",
            "momentum_source_2d": "momentum_source",
            "volume_source_2d": "volume_source",
        }
        dt = self.dt
        advance = self._advance

        def forward(*vals):
            fields = dict(base_fields)
            st = dict(state0)
            for name, v in zip(controls, vals):
                if name == "initial_elev":
                    st["elev"] = v
                elif name == "initial_uv":
                    st["uv"] = v
                elif name.startswith("turbine_density"):
                    fields[name] = self.eq_sw._any_cell_q(v)
                else:
                    fields[name_map[name]] = v

            def body(carry):
                s, t, acc = carry
                s = advance(t, s, fields, tracer_extra, bnd_sw, bnd_tr)
                if step_functional is not None:
                    acc = acc + step_functional(s, fields, t) * dt
                return (s, t + dt, acc)

            carry = (st, 0.0, st["elev"].new_zeros(()))
            use_ckpt = checkpoint if checkpoint is not None else (n > 128)
            if use_ckpt:
                from ..adjoint.checkpointing import checkpointed_scan

                chunk = (checkpoint if isinstance(checkpoint, int)
                         and not isinstance(checkpoint, bool) else None)
                s, _, acc = checkpointed_scan(body, carry, n, chunk=chunk)
            else:
                for _ in range(n):
                    carry = body(carry)
                s, _, acc = carry
            J = acc
            if terminal_functional is not None:
                J = J + terminal_functional(s)
            return J

        return forward

    def load_state(self, i_export, outputdir=None, t=None, iteration=None):
        """Restart from the HDF5 checkpoints of export ``i_export``: every
        prognostic field (tracers, sediment, the Exner bed, NH q/w) is
        restored, on the mesh's device and in its dtype, so the continued
        run is the uninterrupted one (ref ``solver2d.py:820-921``).  The
        solver is initialized first and the fields' tensors are replaced
        after: no solver holds a field's old tensor.  Departure from the
        reference: the restored state counts as exported, so ``iterate()``
        does not write it again and the series goes on at the index and
        time of the uninterrupted run (ROADMAP C)."""
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
        self.next_export_t = (self.simulation_time
                              + self.options.simulation_export_time)
        self.i_export += 1
        for e in self.exporters.values():
            e.set_next_export_ix(self.i_export)
        self._initial_export_done = True

    # ------------------------------------------------------------------
    def assign_initial_conditions(self, elev=None, uv=None, **tracers):
        """ref ``solver2d.py:747-783``, ``:1043-1054``; ``tracer=`` is the
        reference's alias of ``tracer_2d``, ``sediment=`` that of
        ``sediment_2d``; other unknown labels are ignored."""
        if not self._initialized:
            self.initialize()
        if elev is not None:
            self.fields.elev_2d.data = self._interp_to(
                self.function_spaces.H_2d, elev)
        if uv is not None:
            self.fields.uv_2d.data = self._interp_to(
                self.function_spaces.U_2d, uv)
        for label, value in tracers.items():
            if label == "tracer" and "tracer_2d" in self.tracer_labels:
                label = "tracer_2d"
            if label == "sediment":
                label = "sediment_2d"
            if label in self.tracer_labels or (
                    label == "sediment_2d" and self.solve_sediment):
                self.fields[label].data = self._interp_to(
                    self.function_spaces.Q_2d, value)

    def _interp_to(self, space, value):
        if space.family in ("RT", "BDM"):
            v = value.data if isinstance(value, Function) else value
            return space.project_vector(np.asarray(v) if isinstance(
                v, Constant) else v)
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
        """Total water volume (ref ``solver2d.py:1103-1115``): a host sum
        of the cell means for the p = 0 H(div) pairs, the elevation's
        integral plus the bathymetry's otherwise (a CG2 elevation through
        its own tabulations)."""
        eq = self.eq_sw
        eta = self.fields.elev_2d.data
        if isinstance(eq, ShallowWaterEquationsRTDG):
            area = self.mesh2d.cell_area_np
            return float((area * eta[:, 0].detach().cpu().numpy()).sum()
                         + (area * eq.bathy_c.detach().cpu().numpy()).sum())
        if isinstance(eq, ShallowWaterEquationsDGCG):
            eta_int = float(self.asm.integrate_cellq(
                eq.eta_cell_values(eta)))
        else:
            eta_int = float(self.asm.integrate(eta))
        return eta_int + float(self.asm.integrate_cellq(eq.bathy_q))

    def compute_tracer_mass(self, label):
        """Depth-integrated tracer mass (ref ``solver2d.py:1116-1120``)."""
        eta_q = self.asm.cell_values(self.fields.elev_2d.data)
        H_q = self.depth.total_depth(self.eq_sw.bathy_q, eta_q)
        c_q = self.asm.cell_values(self.fields[label].data)
        return float(self.asm.integrate_cellq(H_q * c_q))

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
            tracer_extra = self._gather_tracer_extra(state)
            bnd_sw = self._gather_bnd("shallow_water")
            bnd_tr = self._gather_bnd("tracer")
            state = self._advance(self.simulation_time, state, swe_fields,
                                  tracer_extra, bnd_sw, bnd_tr)
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
        eq = self.eq_sw
        eta, uv = self.fields.elev_2d.data, self.fields.uv_2d.data
        if self.options.element_family in ("rt-dg", "bdm-dg"):
            norm_eta, norm_uv = eq.norm_elev(eta), eq.norm_uv(uv)
        elif isinstance(eq, ShallowWaterEquationsDGCG):
            norm_eta, norm_uv = eq.norm_elev(eta), self.asm.norm_l2(uv)
        else:
            norm_eta, norm_uv = self.asm.norm_l2(eta), self.asm.norm_l2(uv)
        norm_eta, norm_uv = float(norm_eta), float(norm_uv)
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
        if o.log_output and not o.no_exports:
            set_log_directory(o.output_directory)
        # auto-attach the monitors (ref L1040-1085); their series go to
        # HDF5 under export_diagnostics
        dump_hdf5 = o.export_diagnostics and not o.no_exports
        if o.check_volume_conservation_2d:
            self.add_callback(VolumeConservation2DCallback(
                self, export_to_hdf5=dump_hdf5))
        if o.check_tracer_conservation:
            for label in self.tracer_labels:
                self.add_callback(TracerMassConservation2DCallback(
                    label, self, export_to_hdf5=dump_hdf5))
        if o.check_tracer_overshoot:
            for label in self.tracer_labels:
                self.add_callback(TracerOvershootCallBack(
                    label, self, export_to_hdf5=dump_hdf5))

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
            tracer_extra = self._add_sediment_diffusivity(
                self._gather_tracer_extra(state))
            bnd_sw = self._gather_bnd("shallow_water")
            bnd_tr = self._gather_bnd("tracer")
            if use_scan:
                # the reference scans to the next export; a Python loop
                t_target = min(self.next_export_t, o.simulation_end_time)
                n = max(1, int(round((t_target - self.simulation_time)
                                     / self.dt)))
                with timed_stage("coupled_advance"):
                    state = self._advance_n(state, self.simulation_time,
                                            self.dt, n, swe_fields,
                                            tracer_extra, bnd_sw, bnd_tr)
                self.iteration += n
                self.simulation_time += n * self.dt
            else:
                if update_forcings is not None:
                    update_forcings(self.simulation_time + self.dt)
                    swe_fields = self._gather_swe_fields()
                    bnd_sw = self._gather_bnd("shallow_water")
                    bnd_tr = self._gather_bnd("tracer")
                with timed_stage("coupled_advance"):
                    state = self._advance(self.simulation_time, state,
                                          swe_fields, tracer_extra, bnd_sw,
                                          bnd_tr)
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
