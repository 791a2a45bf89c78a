"""The reference's mesh, space, assembly and 3D-operator test files
through ``thetis_tpu_torch`` on the CPU in f64, each test under the
reference test's own name and bounds:

* ``tests/test_fem_core.py``: the mesh's area, boundaries and closed
  normals, exact integration, gradients, trace continuity, the mass
  round trip, the L2 projection, the CG1 space, the cell indicators and
  the DWR estimator, ``timed_stage`` (its docs generator writes the
  reference's own pages and is not mirrored: ROADMAP A, Do not port);
* ``tests/test_3d.py``: the extruded mesh's volume and mass, 3D
  gradients, vertical integrals, 2D<->3D copies, the equations of state,
  the baroclinic head, the vertical velocity (strong and weak), the weak
  w's flux consistency, the 3D tracer's consistency and advection, the
  3D time-series callback and the 3D tracer's ``value`` inflow.

Each runs in well under a second on the CPU but the 3D tracer inflow
(~5 s), so all are tier-1 (the reference marks the inflow ``slow``)."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.eos import (  # noqa: E402
    JackettEquationOfState, LinearEquationOfState)
from thetis_tpu_torch.equations.tracer_3d import (  # noqa: E402
    TracerEquation3D)
from thetis_tpu_torch.equations.utility3d import (  # noqa: E402
    BaroclinicHeadCalculator, VerticalVelocitySolver, expand_function_to_3d,
    extract_bottom_2d, extract_surface_2d)
from thetis_tpu_torch.fem.assembly3d import Assembler3D  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh  # noqa: E402
from thetis_tpu_torch.model.callback import (  # noqa: E402
    TimeSeriesCallback3D)
from thetis_tpu_torch.model.diagnostics import (  # noqa: E402
    DWRErrorEstimator, form2indicator)
from thetis_tpu_torch.model.flowsolver3d import FlowSolver  # noqa: E402
from thetis_tpu_torch.utils.constant import Constant  # noqa: E402
from thetis_tpu_torch.utils.profiling import (  # noqa: E402
    get_timers, print_timers, reset_timers, timed_stage)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def cpu(cls, *args, **kw):
    return cls(*args, device="cpu", dtype=F64, **kw)


def tensor(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# -- tests/test_fem_core.py -------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    return cpu(T.RectangleMesh, 4, 3, 2.0, 1.5)


@pytest.fixture(scope="module")
def asm(mesh):
    return T.DGAssembler(mesh, T.FunctionSpace(mesh, "DG", 1))


def test_mesh_area_and_boundary(mesh):
    assert abs(mesh.total_area - 3.0) < 1e-12
    assert mesh.boundary_len == pytest.approx({1: 1.5, 2: 1.5, 3: 2.0,
                                               4: 2.0})
    assert mesh.boundary_markers == [1, 2, 3, 4]


def test_outward_normals_closed(mesh):
    n, L = mesh.facet_normal_np, mesh.facet_len_np
    cf, cs = mesh.cell_facets_np, mesh.cell_sides_np
    sgn = np.where(cs == 0, 1.0, -1.0)
    per_cell = (n[cf] * L[cf][..., None] * sgn[..., None]).sum(axis=1)
    assert np.abs(per_cell).max() < 1e-12


def test_integration_exact_linear(mesh, asm):
    f = T.Function(asm.space).interpolate(lambda x, y: 2 * x + 3 * y)
    exact = 2 * (2.0 ** 2 / 2) * 1.5 + 3 * (1.5 ** 2 / 2) * 2.0
    assert float(asm.integrate(f.data)) == pytest.approx(exact, rel=1e-13)


def test_integration_exact_cubic():
    m = cpu(T.UnitSquareMesh, 3, 3)
    V = T.FunctionSpace(m, "DG", 2)
    f = T.Function(V).interpolate(lambda x, y: x ** 2 * y)
    assert float(T.DGAssembler(m, V).integrate(f.data)) == pytest.approx(
        1.0 / 6.0, rel=1e-12)


def test_gradients(mesh, asm):
    f = T.Function(asm.space).interpolate(lambda x, y: 2 * x + 3 * y)
    g = asm.cell_grads(f.data).numpy()
    assert np.allclose(g[..., 0], 2.0) and np.allclose(g[..., 1], 3.0)


def test_trace_continuity(mesh, asm):
    f = T.Function(asm.space).interpolate(lambda x, y: 1 + x - 0.5 * y)
    tr = asm.facet_traces(f.data).numpy()
    interior = ~mesh.facet_is_boundary_np
    assert np.abs(tr[interior, 0] - tr[interior, 1]).max() < 1e-12


def test_mass_roundtrip(mesh, asm):
    f = T.Function(asm.space).interpolate(lambda x, y: 0 * x + 1.3)
    r = asm.mass_inverse(asm.mass_apply(f.data))
    assert np.allclose(r.numpy(), f.data.numpy())
    uv = torch.stack([f.data, 2 * f.data], dim=-1)
    assert np.allclose(asm.mass_inverse(asm.mass_apply(uv)).numpy(),
                       uv.numpy())


def test_l2_projection(mesh, asm):
    f = T.Function(asm.space).interpolate(lambda x, y: 0.5 + x + 2 * y)
    p = asm.project_rhs(asm.cell_values(f.data))
    assert np.allclose(p.numpy(), f.data.numpy(), atol=1e-12)


def test_cg_space(mesh):
    V = T.FunctionSpace(mesh, "CG", 1)
    f = T.Function(V).interpolate(lambda x, y: x + y)
    assert tuple(f.data.shape) == (mesh.nv,)
    asm = T.DGAssembler(mesh, T.FunctionSpace(mesh, "DG", 1))
    vals = asm.cell_values(V.cell_dofs(f.data))
    assert float(asm.integrate_cellq(vals)) == pytest.approx(
        (2.0 ** 2 / 2) * 1.5 + (1.5 ** 2 / 2) * 2.0, rel=1e-13)


def test_form2indicator_and_dwr():
    """The cell indicators sum to the integral; the DWR estimator is
    largest near the elevation's bump."""
    m = cpu(T.RectangleMesh, 8, 4, 2.0, 1.0)
    f = T.Function(T.FunctionSpace(m, "DG", 1)).interpolate(
        lambda x, y: 1.0 + x * y)
    p1 = T.FunctionSpace(m, "CG", 1)
    so = T.solver2d.FlowSolver2d(m, T.Function(p1).assign(5.0))
    so.options.timestep = 0.1
    so.options.simulation_export_time = 1.0
    so.options.simulation_end_time = 1.0
    so.options.no_exports = True
    so.assign_initial_conditions(elev=T.Function(p1).interpolate(
        lambda x, y: 0.1 * torch.exp(-(((x - 1.0) / 0.3) ** 2))))
    so.initialize()
    ind = form2indicator(so.asm, so.asm.cell_values(f.data))
    assert tuple(ind.shape) == (m.nc,)
    assert abs(float(ind.sum()) - float(so.asm.integrate(f.data))) < 1e-12
    st = so._get_state()
    adj = {"uv": torch.ones_like(st["uv"]), "elev": torch.ones_like(
        st["elev"])}
    e = DWRErrorEstimator(so).compute({"uv": st["uv"], "elev": st["elev"]},
                                      adj).numpy()
    assert e.shape == (m.nc,) and np.isfinite(e).all()
    xc = np.asarray(m.cell_midpoints())[:, 0]
    near = np.abs(xc - 1.0) < 0.4
    assert e[near].mean() > 2.0 * e[~near].mean()


def test_timed_stage_profiling():
    reset_timers()
    with timed_stage("stage_a"):
        sum(range(1000))
    with timed_stage("stage_a"):
        pass
    with timed_stage("stage_b"):
        pass
    t = get_timers()
    assert t["stage_a"][1] == 2 and t["stage_b"][1] == 1
    assert t["stage_a"][0] >= 0.0
    print_timers()
    reset_timers()
    assert get_timers() == {}


# -- tests/test_3d.py -------------------------------------------------------
@pytest.fixture(scope="module")
def setup3d():
    m = cpu(T.RectangleMesh, 8, 4, 4e3, 2e3)
    a2 = T.DGAssembler(m, T.FunctionSpace(m, "DG", 1))
    ext = ExtrudedMesh(m, n_layers=6)
    a3 = Assembler3D(m, a2, ext)
    bathy = torch.full((m.nc, 3), 10.0, dtype=F64)
    z = ext.z_interfaces(bathy, torch.zeros(m.nc, 3, dtype=F64))
    return m, a2, ext, a3, bathy, z, a3.layer_geometry(z)


def nodes_z(z):
    return torch.stack([z[..., :-1], z[..., 1:]], dim=-1)


def dof_x(m, shape, axis=0):
    xy = T.FunctionSpace(m, "DG", 1).dof_coords()
    return xy[..., axis][:, :, None, None].expand(shape)


def test_volume_and_mass(setup3d):
    m, _, ext, a3, _, _, geom = setup3d
    assert float(a3.wq(geom).sum()) == pytest.approx(4e3 * 2e3 * 10.0,
                                                     rel=1e-12)
    u = tensor(np.random.RandomState(0).rand(m.nc, 3, ext.nz, 2))
    r = a3.mass_inverse(a3.mass_apply(u, geom), geom)
    assert np.allclose(r.numpy(), u.numpy(), atol=1e-10)


def test_gradients_3d(setup3d):
    m, _, ext, a3, _, z, geom = setup3d
    zz = nodes_z(z)
    f = 2 * dof_x(m, zz.shape) + 3 * dof_x(m, zz.shape, 1) - 4 * zz
    g = a3.cell_grads(f, geom).numpy()
    for i, want in enumerate((2.0, 3.0, -4.0)):
        assert np.allclose(g[..., i], want, atol=1e-10)


def test_vertical_integral(setup3d):
    _, _, _, a3, _, z, geom = setup3d
    zz = nodes_z(z)
    assert np.allclose(a3.vertical_integral(zz, geom).numpy(), -50.0,
                       atol=1e-10)
    assert np.allclose(a3.vertical_integral(zz, geom, average=True).numpy(),
                       -5.0, atol=1e-10)
    cum = a3.cumulative_integral(torch.ones_like(zz), geom, from_top=True)
    assert np.allclose(cum.numpy(), -zz.numpy(), atol=1e-10)


def test_2d3d_copies(setup3d):
    m, _, ext, _, _, _, _ = setup3d
    u2 = tensor(np.random.RandomState(1).rand(m.nc, 3))
    u3 = expand_function_to_3d(u2, ext.nz)
    assert tuple(u3.shape) == (m.nc, 3, ext.nz, 2)
    assert np.allclose(extract_surface_2d(u3).numpy(), u2.numpy())
    assert np.allclose(extract_bottom_2d(u3).numpy(), u2.numpy())


def test_eos_values():
    """Jackett et al. (2006): rho(35 psu, 25 C, 2000 dbar) =
    1031.65056056576 kg/m3; the linear EOS at and off its reference."""
    eos = JackettEquationOfState()
    assert float(eos.compute_rho(35.0, 25.0, 2000.0)) == pytest.approx(
        1031.65056056576, abs=1e-6)
    assert float(eos.compute_rho(35.0, 25.0, 0.0)) == pytest.approx(
        1023.3, abs=0.3)
    lin = LinearEquationOfState(rho_ref=1000.0, alpha=0.2, beta=0.77,
                                th_ref=15.0, s_ref=35.0)
    assert float(lin.compute_rho(35.0, 15.0, 0.0)) == 1000.0
    assert float(lin.compute_rho(35.0, 16.0, 0.0)) == pytest.approx(999.8)


def test_baroclinic_head(setup3d):
    m, _, _, a3, _, z, geom = setup3d
    zz = nodes_z(z)
    bhc = BaroclinicHeadCalculator(a3)
    r = bhc.compute_head(torch.ones_like(zz), geom)
    assert np.allclose(r.numpy(), zz.numpy() / 1000.0, atol=1e-12)
    ipg = bhc.compute_int_pg(bhc.compute_head(dof_x(m, zz.shape), geom),
                             geom)
    assert np.allclose(ipg[..., 0].numpy(), 9.81 / 1000.0 * zz.numpy(),
                       atol=1e-6)


def test_vertical_velocity(setup3d):
    m, _, ext, a3, bathy, _, geom = setup3d
    uv = torch.tensor([0.3, 0.1], dtype=F64).expand(m.nc, 3, ext.nz, 2, 2)
    wsolver = VerticalVelocitySolver(a3, bathy)
    assert float(wsolver.solve(uv, geom).abs().max()) < 1e-10
    assert float(wsolver.solve_weak(uv, geom).abs().max()) < 1e-10


def tracer3d(m, a3, lf):
    opts = SimpleNamespace(sipg_factor_tracer=1.0,
                           sipg_factor_vertical_tracer=1.0,
                           use_lax_friedrichs_tracer=lf)
    return TracerEquation3D(m, a3, opts, bnd_conditions={}, label="salt_3d")


def test_vertical_velocity_flux_consistency(setup3d):
    """With the weak w the tracer residual at c == 1 vanishes on every
    row but the free surface's nodes."""
    m, _, ext, a3, bathy, z, geom = setup3d
    zz = nodes_z(z)
    x, y = dof_x(m, zz.shape), dof_x(m, zz.shape, 1)
    u = 0.5 * torch.sin(2 * np.pi * x / 4e3) * torch.cos(
        np.pi * (zz + 10.0) / 10.0)
    v = 0.3 * torch.cos(2 * np.pi * y / 2e3)
    uv3 = torch.stack([u, v], dim=-1)
    w = VerticalVelocitySolver(a3, bathy).solve_weak(uv3, geom)
    c1 = torch.ones(m.nc, 3, ext.nz, 2, dtype=F64)
    r = tracer3d(m, a3, False).residual(
        "all", {"salt_3d": c1}, {"salt_3d": c1}, {"uv_3d": uv3, "w_3d": w},
        {}, {}, geom=geom)["salt_3d"].numpy()
    interior = np.concatenate([r[:, :, :-1, :].ravel(),
                               r[:, :, -1, 0].ravel()])
    assert np.abs(interior).max() < 1e-10 * np.abs(r).max()


def test_tracer3d_consistency(setup3d):
    m, _, ext, a3, _, _, geom = setup3d
    eq = tracer3d(m, a3, True)
    sol = {"salt_3d": torch.full((m.nc, 3, ext.nz, 2), 4.5, dtype=F64)}
    uv = torch.tensor([0.3, 0.0], dtype=F64).expand(m.nc, 3, ext.nz, 2, 2)
    fields = {"uv_3d": uv, "w_3d": torch.zeros(m.nc, 3, ext.nz, 2,
                                               dtype=F64)}
    r = eq.residual("all", sol, sol, fields, fields, {}, geom=geom)
    assert float(eq.mass_inverse(r, geom)["salt_3d"].abs().max()) < 1e-10


def test_tracer3d_advection(setup3d):
    """Ten SSPRK33 steps of a blob in a uniform flow: mass to 2e-3, the
    centroid moved u0 T to 5%."""
    m, _, ext, a3, _, _, geom = setup3d
    eq = tracer3d(m, a3, True)
    x3 = dof_x(m, (m.nc, 3, ext.nz, 2))
    u0, dt = 0.5, 100.0
    uv = torch.tensor([u0, 0.0], dtype=F64).expand(m.nc, 3, ext.nz, 2, 2)
    fields = {"uv_3d": uv, "w_3d": torch.zeros(m.nc, 3, ext.nz, 2,
                                               dtype=F64)}

    def rhs(s):
        return eq.mass_inverse(eq.residual("all", s, s, fields, fields, {},
                                           geom=geom), geom)

    def step(s):
        k0 = rhs(s)
        s1 = {k: s[k] + dt * k0[k] for k in s}
        k1 = rhs(s1)
        s2 = {k: 0.75 * s[k] + 0.25 * (s1[k] + dt * k1[k]) for k in s}
        k2 = rhs(s2)
        return {k: (s[k] + 2 * (s2[k] + dt * k2[k])) / 3.0 for k in s}

    sol = {"salt_3d": torch.exp(-(((x3 - 1.5e3) / 400.0) ** 2))}
    wq = a3.wq(geom)

    def mass(s):
        return float((a3.cell_values(s["salt_3d"]) * wq).sum())

    m0 = mass(sol)
    for _ in range(10):
        sol = step(sol)
    assert abs(mass(sol) - m0) < 2e-3 * abs(m0)
    xq, cq = a3.cell_values(x3), a3.cell_values(sol["salt_3d"])
    centroid = float((xq * cq * wq).sum() / (cq * wq).sum())
    assert centroid == pytest.approx(1.5e3 + u0 * 10 * dt, rel=0.05)


def test_timeseries_callback_3d():
    """A linear-in-z temperature is read back exactly at mid-depth."""
    depth = 20.0
    s = FlowSolver(cpu(T.RectangleMesh, 6, 4, 1e3, 6e2), depth, 5)
    s.options.update(dict(timestep=10.0, simulation_export_time=10.0,
                          simulation_end_time=10.0, no_exports=True,
                          solve_temperature=True, solve_salinity=False))
    s.create_equations()
    sig = np.linspace(-depth, 0.0, 6)
    t0 = 15.0 + 0.2 * np.stack([sig[:-1], sig[1:]], axis=-1)[None, None]
    s.assign_initial_conditions(temp=tensor(np.broadcast_to(t0, s.shape3)))
    cb = TimeSeriesCallback3D(s, ["temp_3d"], 512.0, 333.0, -10.0, "sta")
    val = float(np.ravel(np.asarray(cb()[0]))[0])
    assert abs(val - (15.0 + 0.2 * -10.0)) < 1e-10, val


def test_tracer3d_value_bc_inflow():
    """Inflow through an open boundary carries the prescribed salinity
    in; the outflow side keeps the interior's."""
    lx, ly, nz, depth = 10e3, 2e3, 4, 10.0
    m = cpu(T.RectangleMesh, 10, 2, lx, ly)
    s = FlowSolver(m, depth, nz)
    s.options.update(dict(
        timestep=50.0, simulation_export_time=2500.0,
        simulation_end_time=2500.0, no_exports=True,
        solve_temperature=False, solve_salinity=True,
        use_baroclinic_formulation=False,
        use_implicit_vertical_diffusion=False, use_bottom_friction=False,
        use_limiter_for_tracers=True))
    flux = ly * depth * 0.5
    s.bnd_functions["shallow_water"] = {1: {"flux": Constant(-flux)},
                                        2: {"flux": Constant(flux)}}
    s.bnd_functions["salt"] = {1: {"value": 30.0}}
    s.options.constant_salinity = 35.0
    s.assign_initial_conditions(uv=tensor([0.5, 0.0]))
    s.iterate()
    salt = s.fields.salt_3d.data.numpy()
    assert np.isfinite(salt).all()
    x_dof = m.coords_np[m.cells_np][..., 0]
    assert salt[x_dof < 2e3].min() < 31.0
    assert salt[x_dof > 8e3].mean() > 34.5
    assert salt.min() > 29.7 and salt.max() < 35.1
