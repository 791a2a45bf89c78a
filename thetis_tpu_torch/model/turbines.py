"""Tidal turbine farms.

Port of ``thetis_tpu/model/turbines.py`` (the reference's
``thetis/turbines.py``): thrust and power models (constant and tabulated
thrust curves with the upwind and support-drag corrections, ref
L17-145), continuous-density and discrete (bump-function) farms (ref
L148-210), the power functional callback (ref L213-264), the
minimum-distance constraints (ref L293-368) and the turbine-file loader
(ref L371-419).

Every expression is a torch function of cell-quadrature tensors and takes
their device and dtype.  A discrete farm's density is summed turbine by
turbine, so a farm of hundreds of turbines on a large mesh never holds an
(n_turbines, nc, nq) tensor; the per-turbine discrete integrals are those
of the reference.
"""
import numpy as np
import torch

from ..config import physical_constants
from ..fem.assembly import coefficient_cell_q
from ..utils.log import print_output
from .callback import DiagnosticCallback
from .options import FrozenOptions

__all__ = [
    "TidalTurbineOptions",
    "TidalTurbineFarmOptions",
    "DiscreteTidalTurbineFarmOptions",
    "TidalTurbine",
    "ConstantThrustTurbine",
    "TabulatedThrustTurbine",
    "TidalTurbineFarm",
    "DiscreteTidalTurbineFarm",
    "TurbineFunctionalCallback",
    "MinimumDistanceConstraints",
    "turbine_density_from_coordinates",
    "load_turbine",
]


class TidalTurbineOptions(FrozenOptions):
    """ref ``options.py`` TidalTurbineOptions family."""

    def __init__(self, **kw):
        self.diameter = 18.0
        self.projected_diameter = None
        self.C_support = 0.0
        self.A_support = 0.0
        self.thrust_coefficient = 0.8
        self.power_coefficient = None
        self.thrust_coefficients = None
        self.power_coefficients = None
        self.thrust_speeds = None
        self.apply_shear_profile = False
        self.shear_alpha = 7.0
        self.shear_beta = 0.4
        self.rel_hub_height = None
        self.structure_type = "bottom-fixed"
        self.update(kw)
        self._freeze()


class TidalTurbineFarmOptions(FrozenOptions):
    """ref ``options.py`` TidalTurbineFarmOptions."""

    def __init__(self, **kw):
        self.turbine_type = "constant"
        self.turbine_options = TidalTurbineOptions()
        self.turbine_density = 0.0
        self.break_even_wattage = 0.0
        self.upwind_correction = False
        self.update(kw)
        self._freeze()


class DiscreteTidalTurbineFarmOptions(TidalTurbineFarmOptions):
    def __init__(self, **kw):
        self.turbine_coordinates = []
        self.quadrature_degree = 10
        super().__init__(**kw)


#: rotor-disc vertical sampling weights (ref ``turbines.py:29-34``)
ROTOR_WEIGHTINGS = np.array([0.052, 0.0903, 0.1099, 0.1212, 0.1266,
                             0.1266, 0.1212, 0.1099, 0.0903, 0.052])


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` (constant beyond the ends; a zero-width
    interval takes its left value): ``xp``, ``fp`` numpy tables."""
    xp_t = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp_t = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xp_t, x.contiguous(), right=True), 1,
                    len(xp) - 1)
    df = fp_t[i] - fp_t[i - 1]
    dx = xp_t[i] - xp_t[i - 1]
    delta = x - xp_t[i - 1]
    eps = np.spacing(np.finfo(np.float64 if x.dtype == torch.float64
                              else np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp_t[i - 1],
                    fp_t[i - 1] + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp_t[0], fp_t[0], f)
    return torch.where(x > xp_t[-1], fp_t[-1], f)


class TidalTurbine:
    """ref ``turbines.py:17-93``."""

    def __init__(self, options, upwind_correction=False,
                 rotor_weightings=None):
        self.diameter = options.diameter
        self.projected_diameter = options.projected_diameter or self.diameter
        self.C_support = options.C_support
        self.A_support = options.A_support
        self.upwind_correction = upwind_correction
        self.apply_shear_profile = bool(
            getattr(options, "apply_shear_profile", False))
        self.shear_alpha = float(getattr(options, "shear_alpha", 7.0))
        self.shear_beta = float(getattr(options, "shear_beta", 0.4))
        self.rel_hub_height = getattr(options, "rel_hub_height", None)
        self.structure_type = getattr(options, "structure_type",
                                      "bottom-fixed")
        self.rotor_weightings = np.asarray(
            rotor_weightings if rotor_weightings is not None
            else ROTOR_WEIGHTINGS)

    def rotor_averaged_velocity(self, uv, depth):
        """Cube-weighted rotor-disc average of a power-law shear profile
        (ref ``turbines.py:60-84``): an effective speed per site."""
        if not self.apply_shear_profile:
            return uv
        if self.rel_hub_height is None:
            raise ValueError(
                "`rel_hub_height` must be specified when applying a "
                "shear profile.")
        if self.structure_type == "bottom-fixed":
            hub = self.rel_hub_height          # height above the seabed
        elif self.structure_type == "floating":
            hub = depth - self.rel_hub_height  # depth below the surface
        else:
            raise ValueError(
                f"Unknown turbine structure type '{self.structure_type}'")
        N = len(self.rotor_weightings)
        bshape = (N,) + (1,) * depth.dim()
        offs = torch.as_tensor(
            np.linspace(-self.diameter / 2, self.diameter / 2, N),
            dtype=depth.dtype, device=depth.device).reshape(bshape)
        w = torch.as_tensor(self.rotor_weightings, dtype=depth.dtype,
                            device=depth.device).reshape(bshape)
        z_vals = hub + offs
        umag = torch.sqrt(torch.clamp_min((uv**2).sum(-1), 1e-28))
        u_samples = umag[None] * (
            z_vals / (self.shear_beta * depth)[None]) ** (
                1.0 / self.shear_alpha)
        return (u_samples**3 * w).sum(0) ** (1.0 / 3.0)

    def _thrust_area(self, uv):
        fric = self.thrust_coefficient(uv) * (np.pi * self.diameter**2 / 4)
        if self.C_support:
            fric = fric + self.C_support * self.A_support
        return fric

    def velocity_correction(self, uv, depth):
        if self.upwind_correction:
            fric = self._thrust_area(uv)
            return 0.5 * (1 + torch.sqrt(
                1 - fric / (self.projected_diameter * depth)))
        return 1.0

    def friction_coefficient(self, uv, depth):
        u = (self.rotor_averaged_velocity(uv, depth)
             if self.apply_shear_profile else uv)
        thrust_area = self._thrust_area(u)
        alpha = self.velocity_correction(u, depth)
        return thrust_area / 2.0 / alpha**2

    def power(self, uv, depth):
        """Power per turbine (W) at quadrature points."""
        alpha = self.velocity_correction(uv, depth)
        A_T = np.pi * self.diameter**2 / 4
        if self.apply_shear_profile:
            u_eff = self.rotor_averaged_velocity(uv, depth)
            uv3 = u_eff**3 / alpha**3
        else:
            uv3 = ((uv**2).sum(-1)) ** 1.5 / alpha**3
        C_P = self.power_coefficient(uv3 ** (1.0 / 3.0))
        return 0.5 * physical_constants["rho0"] * A_T * C_P * uv3


class ConstantThrustTurbine(TidalTurbine):
    """ref ``turbines.py:96-106``."""

    def __init__(self, options, upwind_correction=False):
        super().__init__(options, upwind_correction)
        self.C_T = options.thrust_coefficient
        self.C_P = options.power_coefficient or 0.5 * self.C_T * (
            1 + (1 - self.C_T) ** 0.5)

    def thrust_coefficient(self, uv):
        return self.C_T

    def power_coefficient(self, umag):
        return self.C_P


class TabulatedThrustTurbine(TidalTurbine):
    """Piecewise-linear thrust and power curves (ref
    ``turbines.py:128-145``); zero below the first and above the last
    tabulated speed."""

    def __init__(self, options, upwind_correction=False):
        super().__init__(options, upwind_correction)
        self.C_T = np.asarray(options.thrust_coefficients, dtype=float)
        self.speeds = np.asarray(options.thrust_speeds, dtype=float)
        if len(self.C_T) != len(self.speeds):
            raise ValueError("thrust_coefficients and thrust_speeds differ "
                             "in length")
        if options.power_coefficients is not None:
            self.C_P = np.asarray(options.power_coefficients, dtype=float)
        else:
            self.C_P = 0.5 * self.C_T * (1 + (1 - self.C_T) ** 0.5)

    def _interp(self, table, uv_or_umag):
        umag = (torch.sqrt((uv_or_umag**2).sum(-1))
                if uv_or_umag.dim() and uv_or_umag.shape[-1:] == (2,)
                else uv_or_umag)
        val = _interp(umag, self.speeds, table)
        return torch.where((umag < self.speeds[0]) | (umag > self.speeds[-1]),
                           torch.zeros_like(val), val)

    def thrust_coefficient(self, uv):
        return self._interp(self.C_T, uv)

    def power_coefficient(self, umag):
        return self._interp(self.C_P, umag)


def _turbine(options):
    upwind = getattr(options, "upwind_correction", False)
    if options.turbine_type == "constant":
        return ConstantThrustTurbine(options.turbine_options, upwind)
    if options.turbine_type == "table":
        return TabulatedThrustTurbine(options.turbine_options, upwind)
    raise ValueError(f"unknown turbine_type {options.turbine_type}")


class TidalTurbineFarm:
    """Continuous turbine-density farm (ref ``turbines.py:148-173``)."""

    def __init__(self, asm, turbine_density, options, cell_mask=None):
        """
        :arg asm: DGAssembler
        :arg turbine_density: any coefficient ``coefficient_cell_q``
            takes (scalar, CG1, DG or quadrature values)
        :arg cell_mask: optional (nc,) 0/1 mask restricting the farm to a
            subdomain (the reference's dx(subdomain_id))
        """
        self.asm = asm
        self.turbine = _turbine(options)
        self.break_even_wattage = options.break_even_wattage
        density_q = coefficient_cell_q(asm, turbine_density)
        if cell_mask is not None:
            density_q = density_q * asm.as_tensor(cell_mask)[:, None]
        self.turbine_density_q = density_q

    def friction_coefficient_q(self, uv_q, H_q):
        """The drag coefficient the SWE's TurbineDragTerm reads."""
        return self.turbine.friction_coefficient(uv_q, H_q)

    def number_of_turbines(self):
        return float(self.asm.integrate_cellq(self.turbine_density_q))

    def power_output_q(self, uv_q, H_q):
        """Total farm power (W): the integral of power density times
        turbine density."""
        p = self.turbine.power(uv_q, H_q)
        return self.asm.integrate_cellq(p * self.turbine_density_q)


def turbine_density_from_coordinates(asm, coordinates, radius):
    """Sum of C-infinity bump functions at the turbine coordinates, each
    normalised by its discrete integral to one turbine (ref
    ``turbines.py:193-210``); raises when a bump is not resolved by the
    mesh."""
    mesh = asm.mesh
    qp = asm.space._tab_np["qp"]
    p = mesh.coords_np[mesh.cells_np]
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)
    xq = asm.as_tensor(p[:, 0][:, None, :]
                       + np.einsum("cij,qj->cqi", J, qp))  # (nc, nq, 2)
    coords = np.asarray(coordinates, dtype=np.float64).reshape(-1, 2)

    def psi(d):
        d2 = torch.clamp_max(d**2, 1.0 - 1e-12)
        return torch.where(torch.abs(d) < 1.0,
                           torch.exp(1.0 - 1.0 / (1.0 - d2)),
                           torch.zeros_like(d))

    analytic = 1.45661 * radius**2
    density = torch.zeros_like(xq[..., 0])
    integrals = []
    for x0, y0 in coords:
        bump = psi((xq[..., 0] - x0) / radius) * psi((xq[..., 1] - y0)
                                                     / radius)
        integral = (bump * asm.wdetJ).sum()
        integrals.append(float(integral))
        density = density + bump / integral
    if any(i < 0.3 * analytic for i in integrals):
        raise ValueError(
            "turbine bump function is not resolved by the mesh "
            f"(discrete integrals {np.asarray(integrals)} vs analytic "
            f"{analytic:.3g}); refine the mesh near the turbines")
    return density


class DiscreteTidalTurbineFarm(TidalTurbineFarm):
    """Farm of individually placed turbines (ref ``turbines.py:176-210``)."""

    def __init__(self, asm, options, cell_mask=None):
        radius = _turbine(options).projected_diameter * 0.5
        density = turbine_density_from_coordinates(
            asm, options.turbine_coordinates, radius)
        super().__init__(asm, density, options, cell_mask=cell_mask)


class TurbineFunctionalCallback(DiagnosticCallback):
    """Farm power and profit integrated in time (ref
    ``turbines.py:213-264``)."""

    name = "turbine"
    variable_names = ["current_power", "average_power", "average_profit"]

    def __init__(self, solver_obj, **kwargs):
        if not hasattr(solver_obj, "tidal_farms"):
            solver_obj.create_equations()
        self.farms = solver_obj.tidal_farms
        nfarms = len(self.farms)
        super().__init__(solver_obj, array_dim=nfarms, **kwargs)
        self.dt = solver_obj.dt or solver_obj.options.timestep
        self.cost = [farm.number_of_turbines() for farm in self.farms]
        if self.append_to_log:
            print_output(f"Number of turbines = {sum(self.cost)}")
        self.break_even_wattage = [f.break_even_wattage for f in self.farms]
        self.instantaneous_power = [0.0] * nfarms
        self.integrated_power = [0.0] * nfarms
        self.average_power = [0.0] * nfarms
        self.average_profit = [0.0] * nfarms
        self.time_period = 0.0

    def __call__(self):
        so = self.solver_obj
        asm = so.asm
        uv_q = asm.cell_values(so.fields.uv_2d.data)
        eta_q = asm.cell_values(so.fields.elev_2d.data)
        H_q = so.depth.total_depth(so.eq_sw.bathy_q, eta_q, so.eq_sw.alpha_q)
        self.time_period += self.dt
        current = []
        for i, farm in enumerate(self.farms):
            power = float(farm.power_output_q(uv_q, H_q))
            current.append(power)
            self.instantaneous_power[i] = power
            self.integrated_power[i] += power * self.dt
            self.average_power[i] = self.integrated_power[i] / self.time_period
            self.average_profit[i] = (
                self.average_power[i]
                - self.break_even_wattage[i] * self.cost[i])
        return current, list(self.average_power), list(self.average_profit)

    def message_str(self, current, avg_power, avg_profit):
        return ("Current power, average power and profit for each farm: "
                f"{current}, {avg_power}, {avg_profit}")


class MinimumDistanceConstraints:
    """Minimum-distance inequality constraints between turbines for
    position optimisation (ref ``turbines.py:293-368``): ``function(m)``
    gives one value per turbine pair that must be positive and
    ``jacobian(m)`` its gradient, for scipy's SLSQP as ``{'type': 'ineq',
    'fun': ..., 'jac': ...}``."""

    def __init__(self, turbine_positions, minimum_distance):
        self._turbines = [float(xi) for xy in turbine_positions for xi in xy]
        self._minimum_distance = float(minimum_distance)
        self._nturbines = len(turbine_positions)

    def length(self):
        return int(self._nturbines * (self._nturbines - 1) / 2)

    def function(self, m):
        m = np.asarray(m, dtype=float)
        out = []
        for i in range(self._nturbines):
            for j in range(i):
                out.append((m[2 * i] - m[2 * j]) ** 2
                           + (m[2 * i + 1] - m[2 * j + 1]) ** 2
                           - self._minimum_distance ** 2)
        out = np.asarray(out)
        if (out <= 0).any():
            print_output("Minimum distance inequality constraints (should "
                         f"all be > 0): {out}")
        return out

    def jacobian(self, m):
        m = np.asarray(m, dtype=float)
        grad = np.zeros((self.length(), self._nturbines * 2))
        row = 0
        for i in range(self._nturbines):
            for j in range(i):
                grad[row, 2 * i] = 2 * (m[2 * i] - m[2 * j])
                grad[row, 2 * j] = -2 * (m[2 * i] - m[2 * j])
                grad[row, 2 * i + 1] = 2 * (m[2 * i + 1] - m[2 * j + 1])
                grad[row, 2 * j + 1] = -2 * (m[2 * i + 1] - m[2 * j + 1])
                row += 1
        return grad

    def scipy_constraint(self):
        """As a scipy.optimize constraint dict."""
        return {"type": "ineq", "fun": self.function, "jac": self.jacobian}


def load_turbine(path, include_support=True, discrete=True):
    """A farm options object from a YAML or JSON turbine file (ref
    ``turbines.py:371-419``): constant or tabulated thrust and power
    curves and optional support-structure data.  ``yaml`` is imported
    only for ``.yml``/``.yaml`` paths."""
    import json

    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(f)
        else:
            data = json.load(f)

    opts = (DiscreteTidalTurbineFarmOptions() if discrete
            else TidalTurbineFarmOptions())
    opts.turbine_type = data.get("turbine_thrust_def", "constant")
    to = opts.turbine_options
    if opts.turbine_type == "table":
        to.thrust_speeds = data["curves"]["speeds"]
        to.thrust_coefficients = data["curves"]["thrust"]
        to.power_coefficients = data["curves"]["power"]
    else:
        to.thrust_coefficient = data["thrust_coefficient"]
        to.power_coefficient = data.get("power_coefficient")
    if include_support and "support_structure" in data:
        ss = data["support_structure"]
        to.structure_type = ss.get("type", "bottom-fixed")
        to.rel_hub_height = ss.get("rel_hub_height")
        to.C_support = ss.get("C_support", 0.0)
        to.A_support = ss.get("A_support", 0.0)
    to.diameter = data["diameter"]
    if discrete:
        opts.upwind_correction = data.get("upwind_correction", True)
    return opts
