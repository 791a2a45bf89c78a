"""``examples/tidalfarm``'s profit functional through the port's adjoint
against the reference's (f64, CPU): the example's set-up on a 12x4
channel over 2 steps, the gradient with respect to the turbine density
(``turbine_density_{i}`` through ``eq_sw._any_cell_q``) against
``jax.grad`` (1e-10 of the largest entry), and the port's Taylor rate.
The reference's solver is built as the example builds it and carried to
the port by ``interop``."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thetis_tpu as J  # noqa: E402
from thetis_tpu.model.turbines import (  # noqa: E402
    TidalTurbineFarmOptions as JFarm, TidalTurbineOptions as JTurbine)
from thetis_tpu_torch.adjoint import (  # noqa: E402
    Control, ReducedFunctional, taylor_test)
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from test_torch_adjoint_swe import agree  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def farm(nx=12, ny=4, lx=2000.0, ly=600.0):
    """``examples/tidalfarm``'s set-up on a coarser channel (the
    reference), and the port's copy of it."""
    jm = J.RectangleMesh(nx, ny, lx, ly)
    p1 = J.FunctionSpace(jm, "CG", 1)
    so = J.solver2d.FlowSolver2d(jm, J.Function(p1).assign(40.0))
    o = so.options
    o.timestep = 10.0
    o.simulation_export_time = 200.0
    o.simulation_end_time = 200.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = J.Constant(2.0)
    o.quadratic_drag_coefficient = J.Constant(0.0025)
    f = JFarm()
    f.turbine_options = JTurbine(diameter=18.0, thrust_coefficient=0.8)
    x, y = J.SpatialCoordinate(jm)
    mask = (jnp.abs(x - lx / 2) < 300.0) & (jnp.abs(y - ly / 2) < 200.0)
    f.turbine_density = J.Function(p1).interpolate(
        jnp.where(mask, 0.003, 0.0))
    f.break_even_wattage = 200.0
    o.tidal_turbine_farms = {"everywhere": [f]}
    so.bnd_functions["shallow_water"] = {1: {"un": J.Constant(-2.0)},
                                         2: {"elev": J.Constant(0.0)}}
    so.assign_initial_conditions(uv=jnp.asarray([2.0, 0.0]), elev=0.0)
    so.initialize()
    port = flowsolver2d_from_reference(so, tgen.RectangleMesh(
        nx, ny, lx, ly, device="cpu", dtype=F64))
    return so, port


def profit_forward(s, n_steps):
    """The example's average-profit step functional, either package."""
    asm, farm_obj, dt = s.asm, s.tidal_farms[0], s.dt
    wattage = 200.0

    def profit_step(state, fields, t):
        uv_q = asm.cell_values(state["uv"])
        eta_q = asm.cell_values(state["elev"])
        H_q = s.depth.total_depth(s.eq_sw.bathy_q, eta_q)
        density_q = fields["turbine_density_0"]
        power = asm.integrate_cellq(
            farm_obj.turbine.power(uv_q, H_q) * density_q)
        cost = wattage * asm.integrate_cellq(density_q)
        return (power - cost) / (n_steps * dt)

    return s.differentiable_forward(["turbine_density_0"],
                                    step_functional=profit_step,
                                    n_steps=n_steps)


def test_farm_density_gradient():
    so, port = farm()
    assert len(port.tidal_farms) == 1
    d0 = np.asarray(so.options.tidal_turbine_farms["everywhere"][0]
                    .turbine_density.data)
    jv, jg = jax.jit(jax.value_and_grad(profit_forward(so, 2)))(
        jnp.asarray(d0))
    fp = profit_forward(port, 2)
    dt_ = torch.tensor(d0, requires_grad=True)
    tv = fp(dt_)
    (tg,) = torch.autograd.grad(tv, dt_)
    agree((float(tv.detach()), [tg.numpy()]), (float(jv), [np.asarray(jg)]))
    rf = ReducedFunctional(fp, Control(torch.tensor(d0)), scale=-1e-5)
    rng = np.random.default_rng(3)
    assert taylor_test(rf, d0, 0.001 * rng.random(d0.shape), h0=0.2) > 1.9
