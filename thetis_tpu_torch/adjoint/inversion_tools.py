r"""Inversion / data-assimilation toolkit (port of
``thetis_tpu/adjoint/inversion_tools.py``, itself a re-implementation of
``thetis/inversion_tools.py``) on torch autograd:

  StationObservationManager: observed station time series, in-run model
      sampling by barycentric interpolation, the misfit inside the
      differentiable forward
  GradientRegularizationCalculator: gamma |dx grad(c)|^2
  HessianRegularizationCalculator: gamma |dx^2 H(c)|^2
  RSpaceRegularizationCalculator: deviation from the initial value for
      scalar (R-space) controls
  InversionManager: controls + cost function, ReducedFunctional
      construction, scipy minimize, progress output (``np.save``),
      consistency and Taylor tests
"""
import os

import numpy as np
import torch

from .reduced_functional import Control, ReducedFunctional, taylor_test, minimize
from ..utils.log import print_output

__all__ = [
    "StationObservationManager",
    "GradientRegularizationCalculator",
    "HessianRegularizationCalculator",
    "RSpaceRegularizationCalculator",
    "InversionManager",
]


class StationObservationManager:
    """Holds observation time series and samples the model at station
    locations inside the differentiable forward (ref L560-918)."""

    def __init__(self, solver_obj, output_directory=None):
        self.solver_obj = solver_obj
        self.output_directory = output_directory
        self.station_names = []
        self._xy = []
        self._obs_times = []
        self._obs_values = []
        self._built = False

    def register_observation_data(self, station_names, variable, time,
                                  values, x, y, start_times=None,
                                  end_times=None):
        """ref L617-668; ``variable`` 'elev' (elevation series)."""
        self.variable = variable
        for i, name in enumerate(station_names):
            self.station_names.append(name)
            self._xy.append((float(x[i]), float(y[i])))
            self._obs_times.append(np.asarray(time[i], dtype=float))
            self._obs_values.append(np.asarray(values[i], dtype=float))

    def construct_evaluator(self):
        """Owner cells and barycentric weights of the stations (the
        reference's VertexOnlyMesh interpolation, ref L690-740), on the
        host; the first containing cell in index order, else the cell of
        the nearest centroid."""
        mesh = self.solver_obj.mesh2d
        coords = mesh.coords_np
        cells = mesh.cells_np
        pts = np.asarray(self._xy)
        cell_ids = np.zeros(len(pts), dtype=np.int64)
        bary = np.zeros((len(pts), 3))
        p0, p1, p2 = (coords[cells[:, i]] for i in range(3))
        for i, p in enumerate(pts):
            v0 = p1 - p0
            v1 = p2 - p0
            v2 = p[None, :] - p0
            d00 = (v0 * v0).sum(1)
            d01 = (v0 * v1).sum(1)
            d11 = (v1 * v1).sum(1)
            d20 = (v2 * v0).sum(1)
            d21 = (v2 * v1).sum(1)
            denom = d00 * d11 - d01 * d01
            v = (d11 * d20 - d01 * d21) / denom
            w = (d00 * d21 - d01 * d20) / denom
            u = 1.0 - v - w
            inside = (u >= -1e-10) & (v >= -1e-10) & (w >= -1e-10)
            cand = np.nonzero(inside)[0]
            if len(cand) == 0:
                mids = coords[cells].mean(axis=1)
                cand = [np.argmin(((mids - p) ** 2).sum(1))]
            c = int(cand[0])
            cell_ids[i] = c
            bary[i] = [u[c], v[c], w[c]]
        self.cell_ids = torch.as_tensor(cell_ids, device=mesh.device)
        self.bary = torch.as_tensor(bary, dtype=mesh.dtype, device=mesh.device)
        self._built = True

    def sample(self, state):
        """Elevation at the stations from a state dict."""
        if not self._built:
            self.construct_evaluator()
        return (state["elev"][self.cell_ids] * self.bary).sum(-1)

    def observations_at(self, t):
        """Observation values interpolated at time t (host)."""
        return np.asarray(
            [np.interp(t, ot, ov)
             for ot, ov in zip(self._obs_times, self._obs_values)]
        )

    def misfit_step_functional(self, dt, n_steps, t0=0.0):
        """``f(state, fields, t)`` accumulating the station misfit; the
        observation series are interpolated onto the model's time grid
        beforehand (the reference interpolates in-tape, ref L741-800).
        ``t`` is the step's start time, as the forward passes it."""
        times = t0 + dt * (1 + np.arange(n_steps))
        obs = np.stack([self.observations_at(t) for t in times])  # (nt, ns)
        mesh = self.solver_obj.mesh2d
        obs = torch.as_tensor(obs, dtype=mesh.dtype, device=mesh.device)

        def f(state, fields, t):
            it = int(np.clip(np.round((t - t0) / dt), 0, n_steps - 1))
            model = self.sample(state)
            # the integrand: the caller's * dt makes it a plain sum over
            # the steps
            return ((model - obs[it]) ** 2).sum() / dt

        return f


class GradientRegularizationCalculator:
    r"""R = gamma * int |dx grad(c)|^2 dx / area  (ref L919-967)."""

    def __init__(self, asm, gamma, scaling=1.0):
        self.asm = asm
        self.gamma = gamma
        self.scaling = scaling
        mesh = asm.mesh
        self.dx2 = asm.as_tensor(mesh.cell_hmin_np**2)
        self.area = mesh.total_area

    def __call__(self, c):
        mesh = self.asm.mesh
        cd = c[mesh.cells] if c.shape[:1] == (mesh.nv,) else c
        g = self.asm.cell_grads(cd)  # (nc, nq, 2)
        e = self.dx2[:, None] * (g**2).sum(-1)
        return (self.scaling * self.gamma * self.asm.integrate_cellq(e)
                / self.area)


class HessianRegularizationCalculator:
    r"""R = gamma * int |dx^2 H(c)|^2 dx / area (ref L969-1017), with the
    Hessian by double L2 recovery."""

    def __init__(self, asm, gamma, scaling=1.0):
        from ..model.diagnostics import HessianRecoverer2D

        self.asm = asm
        self.gamma = gamma
        self.scaling = scaling
        self.recoverer = HessianRecoverer2D(asm)
        mesh = asm.mesh
        self.dx4 = asm.as_tensor(mesh.cell_hmin_np**4)
        self.area = mesh.total_area

    def __call__(self, c):
        H = self.recoverer.solve(c)  # (nv, 2, 2)
        Hq = self.asm.cell_values(H[self.asm.mesh.cells])
        e = self.dx4[:, None] * (Hq**2).sum((-1, -2))
        return (self.scaling * self.gamma * self.asm.integrate_cellq(e)
                / self.area)


class RSpaceRegularizationCalculator:
    r"""R = gamma (c - c_0)^2 / eps for scalar controls (ref L1019-1045)."""

    def __init__(self, gamma, initial_value, eps=1e-6, scaling=1.0):
        self.gamma = gamma
        self.c0 = initial_value
        self.eps = eps
        self.scaling = scaling

    def __call__(self, c):
        return self.scaling * self.gamma * ((c - self.c0) ** 2).sum() / self.eps


class InversionManager:
    """Assembles the controls, the misfit and the regularisation into a
    ReducedFunctional and drives the optimisation (ref L153-558)."""

    def __init__(self, sta_manager, output_dir="outputs_inv",
                 real_cost_function_scaling=1.0, penalty_parameters=None,
                 cost_function_scaling=None, no_exports=True):
        self.sta_manager = sta_manager
        self.solver_obj = sta_manager.solver_obj
        self.output_dir = output_dir
        self.scaling = (
            cost_function_scaling
            if cost_function_scaling is not None
            else real_cost_function_scaling
        )
        self.penalty_parameters = penalty_parameters or []
        self.control_names = []
        self.controls = []
        self.regularizations = []
        self.control_mappings = []
        self.progress = {"J": [], "controls": []}
        self.no_exports = no_exports

    def add_control(self, name, initial_value, regularization=None,
                    mapping=None):
        """:arg name: a control name understood by
        ``FlowSolver2d.differentiable_forward``
        :kwarg mapping: optional differentiable map from the control
            value to the solver field (region-mask / independent-points
            parameterisations): the optimiser sees the raw control, the
            model the mapped field.  The regularisation applies to the
            raw control."""
        self.control_names.append(name)
        self.controls.append(Control(initial_value, name=name))
        self.regularizations.append(regularization)
        self.control_mappings.append(mapping)

    def get_cost_function(self, n_steps, checkpoint=None):
        """J(controls) = sum_t sum_s (model - obs)^2 + sum reg (ref
        L384-470).  ``checkpoint`` selects adjoint memory checkpointing
        (see ``FlowSolver2d.differentiable_forward``)."""
        so = self.solver_obj
        dt = so.dt or so.options.timestep
        step_f = self.sta_manager.misfit_step_functional(dt, n_steps)
        fwd = so.differentiable_forward(
            self.control_names, step_functional=step_f, n_steps=n_steps,
            checkpoint=checkpoint,
        )
        regs = self.regularizations
        maps = self.control_mappings

        def J(*control_values):
            mapped = [m(c) if m is not None else c
                      for m, c in zip(maps, control_values)]
            out = fwd(*mapped) * self.scaling
            for reg, c in zip(regs, control_values):
                if reg is not None:
                    out = out + self.scaling * reg(c)
            return out

        return J

    def get_reduced_functional(self, n_steps, checkpoint=None):
        def cb(j, grads, values):
            self.progress["J"].append(j)
            self.progress["controls"].append(
                [v.detach().cpu().numpy() for v in values])
            print_output(f"Inversion: J = {j:.6e}")

        self.rf = ReducedFunctional(
            self.get_cost_function(n_steps, checkpoint=checkpoint),
            self.controls, derivative_cb_post=cb,
        )
        return self.rf

    def minimize(self, opt_method="L-BFGS-B", bounds=None, **opt_options):
        assert hasattr(self, "rf"), "call get_reduced_functional first"
        os.makedirs(self.output_dir, exist_ok=True)
        result = minimize(self.rf, method=opt_method, bounds=bounds,
                          options=opt_options)
        np.save(os.path.join(self.output_dir, "progress_J.npy"),
                np.asarray(self.progress["J"]))
        return result

    def consistency_test(self, n_steps=None):
        """J evaluates identically twice at the same controls
        (ref L531-542)."""
        v = [c.value for c in self.controls]
        j1 = self.rf(v)
        j2 = self.rf(v)
        assert j1 == j2, f"inconsistent cost function: {j1} != {j2}"
        return True

    def taylor_test(self, h0=1e-3):
        """Gradient consistency (ref L543-558)."""
        c = self.controls[0].value
        rng = np.random.RandomState(0)
        dc = torch.as_tensor(rng.rand(*c.shape) if c.dim() else rng.rand(),
                             dtype=c.dtype, device=c.device)
        rate = taylor_test(self.rf, c, dc, h0=h0)
        assert rate > 1.9, f"taylor test failed: rate {rate}"
        return rate
