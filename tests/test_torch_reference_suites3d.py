"""The reference's 3D test files that no other port test named, through
``thetis_tpu_torch`` on the CPU in f64, each test under the reference
test's own name and bounds:

* ``tests/test_momentum3d.py`` (its ``test_hviscosity_mes`` is in
  ``test_torch_convergence3d.py``): the rest state, the lock exchange's
  direction, the implicit vertical viscosity, the uniform flow through
  open boundaries, the law-of-the-wall friction and Smagorinsky's effect
  on the step;
* ``tests/test_ekman.py``: the bottom and surface Ekman spirals at 50
  layers, the examples' own functions (``examples/bottomFriction``) run
  through the port from their source, rewritten by
  ``chip_smoke.REWRITE_TABLE`` as phase 30 runs the scripts;
* ``tests/test_fixed_mesh.py``: the barotropic wave on the fixed mesh
  against the ALE mesh, and the 2D options' conservative-form trait.

The reference marks every test here ``slow`` but the trait; on the port
each runs in under ~20 s on the CPU (the Ekman spirals the longest), so
all are tier-1."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.eos import (  # noqa: E402
    LinearEquationOfState)
from thetis_tpu_torch.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D, vertical_viscosity_implicit)
from thetis_tpu_torch.equations.utility3d import (  # noqa: E402
    BaroclinicHeadCalculator)
from thetis_tpu_torch.fem.assembly3d import Assembler3D  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh  # noqa: E402
from thetis_tpu_torch.model.flowsolver3d import FlowSolver  # noqa: E402
from thetis_tpu_torch.model.options import ModelOptions2d  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def rect(*args):
    return T.RectangleMesh(*args, device="cpu", dtype=F64)


def zeros(*shape):
    return torch.zeros(*shape, dtype=F64)


# -- tests/test_momentum3d.py -----------------------------------------------
@pytest.fixture(scope="module")
def setup():
    mesh = rect(16, 2, 16e3, 2e3)
    asm = T.DGAssembler(mesh, T.FunctionSpace(mesh, "DG", 1))
    ext = ExtrudedMesh(mesh, n_layers=8)
    a3 = Assembler3D(mesh, asm, ext)
    bathy = torch.full((mesh.nc, 3), 20.0, dtype=F64)
    geom = a3.layer_geometry(ext.z_interfaces(bathy, zeros(mesh.nc, 3)))
    opts = SimpleNamespace(use_nonlinear_equations=True,
                           use_lax_friedrichs_velocity=True, sipg_factor=1.0)
    return mesh, ext, a3, geom, opts


def test_momentum_rest_state(setup):
    mesh, ext, a3, geom, opts = setup
    eq = MomentumEquation3D(mesh, a3, opts)
    sol = {"uv_3d": zeros(mesh.nc, 3, ext.nz, 2, 2)}
    r = eq.residual("all", sol, sol, {"w_3d": zeros(mesh.nc, 3, ext.nz, 2)},
                    {}, {}, geom=geom)
    assert float(r["uv_3d"].abs().max()) < 1e-12


def test_lock_exchange_direction(setup):
    """Dense water on the left drives the bottom flow toward +x, and the
    acceleration falls toward the surface."""
    mesh, ext, a3, geom, opts = setup
    eq = MomentumEquation3D(mesh, a3, opts)
    eos = LinearEquationOfState(rho_ref=1000.0, alpha=0.2)
    xy = T.FunctionSpace(mesh, "DG", 1).dof_coords()
    x3 = xy[..., 0][:, :, None, None].expand(mesh.nc, 3, ext.nz, 2)
    temp = 10.0 + 5.0 * torch.tanh((x3 - 8e3) / 1e3)
    rho_prime = eos.compute_rho(35.0, temp, 0.0, 1000.0)
    bhc = BaroclinicHeadCalculator(a3)
    int_pg = bhc.compute_int_pg(bhc.compute_head(rho_prime, geom), geom)
    sol = {"uv_3d": zeros(mesh.nc, 3, ext.nz, 2, 2)}
    fields = {"w_3d": zeros(mesh.nc, 3, ext.nz, 2), "int_pg_3d": int_pg}
    r = eq.residual("all", sol, sol, fields, fields, {}, geom=geom)
    duv = eq.mass_inverse(r, geom)["uv_3d"].numpy()
    mask = np.abs(x3[:, :, 0, 0].numpy() - 8e3) < 2e3
    du_bot = duv[:, :, 0, 0, 0][mask]
    du_top = duv[:, :, -1, 1, 0][mask]
    assert du_bot.mean() > 0, "bottom flow should accelerate toward +x"
    assert du_bot.mean() > du_top.mean()


def test_vertical_viscosity_implicit(setup):
    """Momentum kept (no fluxes), shear reduced, the wind accelerating
    the surface."""
    mesh, ext, a3, geom, opts = setup
    Dn = geom["Delta_nodes"]
    shape = (mesh.nc, 3, ext.nz, 2)
    bathy = torch.full((mesh.nc, 3), 20.0, dtype=F64)
    z = ext.z_interfaces(bathy, zeros(mesh.nc, 3))
    zz = torch.stack([z[..., :-1], z[..., 1:]], dim=-1)
    uv = zeros(*shape, 2)
    uv[..., 0] = (zz + 20.0) / 20.0
    nu = torch.full(shape, 1e-2, dtype=F64)
    out = vertical_viscosity_implicit(uv, nu, Dn, dt=600.0)
    w = 0.5 * torch.stack([Dn, Dn], -1)
    m0 = float((uv[..., 0] * w).sum())
    m1 = float((out[..., 0] * w).sum())
    assert m1 == pytest.approx(m0, rel=1e-10)
    shear0 = float(torch.diff(uv[..., 0], dim=2).abs().sum())
    shear1 = float(torch.diff(out[..., 0], dim=2).abs().sum())
    assert shear1 < shear0
    tau = zeros(mesh.nc, 3, 2)
    tau[..., 0] = 1e-4
    out2 = vertical_viscosity_implicit(uv, nu, Dn, dt=600.0, stress_top=tau)
    assert float(out2[..., -1, 1, 0].mean()) > float(out[..., -1, 1, 0].mean())


def test_hadv_open_boundary_uniform_flow(setup):
    """External uv equal to the interior: no tendency at the open
    boundary; the land mirror (no condition) makes one."""
    mesh, ext, a3, geom, opts = setup
    u0 = 0.7
    bnd = {m: {"uv": (u0, 0.0)} for m in mesh.boundary_markers}
    eq = MomentumEquation3D(mesh, a3, opts, bnd_conditions=bnd)
    uv = zeros(mesh.nc, 3, ext.nz, 2, 2)
    uv[..., 0] = u0
    w = zeros(mesh.nc, 3, ext.nz, 2)
    sol = {"uv_3d": uv}
    bndv = {m: {"uv": torch.tensor([u0, 0.0], dtype=F64)}
            for m in mesh.boundary_markers}
    r = eq.residual("explicit", sol, sol, {"w_3d": w}, {}, bndv, geom=geom)
    assert float(eq.mass_inverse(r, geom)["uv_3d"].abs().max()) < 1e-10
    eq0 = MomentumEquation3D(mesh, a3, opts)
    r0 = eq0.residual("explicit", sol, sol, {"w_3d": w}, {}, {}, geom=geom)
    assert float(eq0.mass_inverse(r0, geom)["uv_3d"].abs().max()) > 1e-6


def one_step_solver(**options):
    """An 8 x 4 rectangle x 4 layers, 20 m deep, one 300 s step's
    options (``test_momentum3d.py``'s runs)."""
    s = FlowSolver(rect(8, 4, 8e3, 4e3), 20.0, 4)
    s.options.update(dict(
        timestep=300.0, simulation_export_time=300.0,
        simulation_end_time=300.0, solve_salinity=False,
        solve_temperature=False, use_baroclinic_formulation=False,
        **options))
    s.initialize()
    return s


def test_law_of_wall_bottom_friction():
    """Larger roughness decelerates a uniform flow more; an explicit zero
    drag coefficient overrides the log fit."""
    def run(z0=None, cd=None):
        s = one_step_solver(use_bottom_friction=True,
                            bottom_roughness=z0 if z0 is not None else 0.005,
                            quadratic_drag_coefficient=cd)
        s.assign_initial_conditions(uv=torch.tensor([0.5, 0.0], dtype=F64))
        out = s._step(s._get_state(), s._gather_swe_fields(), {})
        ub = out["uv_3d"][:, :, 0, 0, :] + out["uv"]
        return float(ub[..., 0].abs().mean())

    u_smooth, u_rough, u_nodrg = run(z0=1e-4), run(z0=0.05), run(cd=0.0)
    assert u_rough < u_smooth < u_nodrg, (u_rough, u_smooth, u_nodrg)


def test_smagorinsky_wired():
    """``use_smagorinsky_viscosity`` changes the step, and diffuses the
    sheared component."""
    def run(use_smag):
        s = one_step_solver(use_bottom_friction=False,
                            use_smagorinsky_viscosity=use_smag,
                            smagorinsky_coefficient=0.5)
        mesh = s.mesh2d
        xy = T.FunctionSpace(mesh, "DG", 1).dof_coords()
        nz = s.extruded.nz
        y3 = xy[..., 1][:, :, None, None].expand(mesh.nc, 3, nz, 2)
        z = s.extruded.z_interfaces(s.bathy_cell, zeros(mesh.nc, 3))
        zz = torch.stack([z[..., :-1], z[..., 1:]], dim=-1)
        uv3 = zeros(mesh.nc, 3, nz, 2, 2)
        uv3[..., 0] = (0.2 * torch.sin(2 * np.pi * y3 / 4e3)
                       * (zz + 10.0) / 10.0)
        s.assign_initial_conditions(uv_3d=uv3)
        return s._step(s._get_state(), s._gather_swe_fields(),
                       {})["uv_3d"].numpy()

    a, b = run(False), run(True)
    assert not np.allclose(a, b), "Smagorinsky option must affect the step"
    assert np.abs(b[..., 0]).max() <= np.abs(a[..., 0]).max() + 1e-12


# -- tests/test_ekman.py ----------------------------------------------------
def port_example(name):
    """``examples/bottomFriction/<name>.py`` through the port: its source
    rewritten by ``chip_smoke.REWRITE_TABLE``, run as a module (not as
    ``__main__``) with every mesh on the CPU in f64; returns its globals
    and the context its functions must run under."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "bottomFriction",
        name + ".py")
    with open(path) as f:
        code = compile(chip_smoke.translate(f.read()), path, "exec")
    ns = {"__name__": "_port_" + name, "__file__": path}
    with chip_smoke.jax_shims("cpu", F64):
        exec(code, ns)
    return ns, lambda: chip_smoke.mesh_defaults("cpu", F64)


def total_uv(s):
    return (s.fields.uv_3d.data
            + s.fields.uv_2d.data[:, :, None, None, :]).numpy()


@pytest.mark.parametrize("name,run", [("ekman_bottom", "bottom_ekman_test"),
                                      ("ekman_surface",
                                       "surface_ekman_test")],
                         ids=["bottom", "surface"])
def test_ekman_spiral(name, run, monkeypatch):
    """``test_ekman.py::test_ekman_bottom_spiral`` and
    ``test_ekman_surface_spiral``: 50 layers, the example's whole run, the
    rms velocity error against the analytic spiral < 0.05 m/s."""
    monkeypatch.delenv("THETIS_REGRESSION_TEST", raising=False)
    ns, on_cpu = port_example(name)
    with on_cpu():
        s = ns[run](layers=50, iterate=True)
        u_ana, v_ana = ns["analytical_uv"](s)
    uv = total_uv(s)
    err = np.sqrt(np.mean((uv[..., 0] - u_ana) ** 2
                          + (uv[..., 1] - v_ana) ** 2))
    print(f"port {name}: rms error {err:.4f} m/s")
    assert err < 0.05, err


# -- tests/test_fixed_mesh.py -----------------------------------------------
def test_fixed_mesh_barotropic_wave():
    """The frozen mesh stays finite and tracks the ALE run's elevation to
    5% of its largest value."""
    lx, depth = 20e3, 20.0
    outs = {}
    for ale in (True, False):
        mesh2d = rect(12, 2, lx, 4e3)
        p1 = T.FunctionSpace(mesh2d, "CG", 1)
        so = FlowSolver(mesh2d, T.Function(p1).assign(depth), 4)
        o = so.options
        o.timestep = 30.0
        o.simulation_export_time = 300.0
        o.simulation_end_time = 300.0
        o.no_exports = True
        o.solve_salinity = False
        o.solve_temperature = False
        o.use_baroclinic_formulation = False
        o.use_implicit_vertical_diffusion = False
        o.use_bottom_friction = False
        o.horizontal_viscosity = 1.0
        o.use_ale_moving_mesh = ale
        so.assign_initial_conditions(elev=T.Function(p1).interpolate(
            lambda x, y: 0.05 * torch.exp(-(((x - lx / 2) / 3e3) ** 2))))
        so.iterate()
        outs[ale] = (so.fields.elev_2d.data.numpy(),
                     so.fields.uv_3d.data.numpy())
    e_ale, e_fix = outs[True][0], outs[False][0]
    assert np.isfinite(e_fix).all() and np.isfinite(outs[False][1]).all()
    assert np.abs(e_fix - e_ale).max() < 0.05 * np.abs(e_ale).max()


def test_tracer_conservative_form_trait():
    o = ModelOptions2d()
    o.add_tracer_2d("a_2d")
    assert o.tracer["a_2d"].use_conservative_form is False
    o.use_tracer_conservative_form = True
    o.add_tracer_2d("b_2d")
    assert o.tracer["b_2d"].use_conservative_form is True
    o.add_tracer_2d("c_2d", use_conservative_form=False)
    assert o.tracer["c_2d"].use_conservative_form is False
