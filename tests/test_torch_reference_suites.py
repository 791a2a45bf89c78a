"""The reference's tier-1 2D test files that no other port test names,
through ``thetis_tpu_torch`` on the CPU in f64, each test under the
reference test's own name and bounds:

* ``tests/test_periodic.py``: the x-periodic mesh's geometry, a tracer
  carried once around it (the seam crossed, mass to 1e-10) and a uniform
  momentum source giving a uniform flow;
* ``tests/test_tracer_cg.py``: the CG1 tracer's ladder 20 / 40 / 80
  (rate > 1.3) and SUPG's bounded front;
* ``tests/test_swe_channel.py``: the demo channel's initial norm, its
  Crank-Nicolson trace, SSPRK33's stability and volume, and
  ``create_iterator`` against ``iterate``;
* ``tests/test_options_wiring.py``: ``simulation_end_date``, the log and
  the HDF5 diagnostics, ``no_exports``, and the tracer's Picard
  iterations (``slow`` in the reference; ~2 s on the port, so tier-1);
* ``tests/test_native.py``: the port's native facet builder
  (``thetis_tpu_torch/native``) against its numpy fallback;
* ``tests/test_multiple_tracers.py``: ``demos/demo_2d_multiple_tracers.py``
  from its source at regression size (``chip_smoke.run_script``);
* ``tests/test_standing_wave.py``: one period of the closed channel's
  standing wave, fully implicit CrankNicolson at 10, 20 and 40 steps and
  PressureProjectionPicard on dg-cg at 20 (``slow``: ~110 s on the CPU,
  where the CN cases take 8-18 s).

These tests hold the port to the reference's bounds; the parity of these
paths with ``thetis_tpu`` is in the files named in
``tests/test_torch_reference_coverage.py``."""
import datetime
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch import solver2d  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations, swe_state)
import thetis_tpu_torch.native as tnative  # noqa: E402
from thetis_tpu_torch.solvers.newton import NewtonParameters  # noqa: E402
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    CrankNicolson, get_stepper)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def cpu_mesh(cls, *args, **kw):
    return cls(*args, device="cpu", dtype=F64, **kw)


def tensor(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# -- tests/test_periodic.py -------------------------------------------------
def test_periodic_geometry():
    lx, ly = 10e3, 2e3
    mesh = cpu_mesh(T.PeriodicRectangleMesh, 40, 8, lx, ly)
    assert mesh.nv == 40 * 9
    assert np.allclose(np.asarray(mesh.detJ_np), mesh.detJ_np[0])
    assert sorted(mesh.boundary_markers) == [1, 2]
    area = float(np.asarray(mesh.cell_area_np).sum())
    assert abs(area - lx * ly) < 1e-6 * lx * ly


def test_periodic_full_circuit_advection():
    lx, ly = 10e3, 2e3
    u0 = 1.0
    mesh = cpu_mesh(T.PeriodicRectangleMesh, 40, 8, lx, ly)
    bathy = T.Function(T.FunctionSpace(mesh, "CG", 1)).assign(10.0)
    so = solver2d.FlowSolver2d(mesh, bathy)
    o = so.options
    o.tracer_only = True
    o.add_tracer_2d("tracer_2d", "T", "T", "-", None)
    o.tracer_timestepper_type = "SSPRK33"
    o.timestep = 0.2 * (lx / 40) / u0
    o.simulation_export_time = lx / u0
    o.simulation_end_time = lx / u0 - 0.1 * o.timestep
    o.no_exports = True
    so.create_function_spaces()
    c0 = T.Function(so.function_spaces.Q_2d).interpolate(
        lambda x, y: torch.exp(-(((x - 3e3) / 800.0) ** 2)))
    so.assign_initial_conditions(uv=np.asarray([u0, 0.0]), tracer_2d=c0)
    so.iterate()
    c1 = so.fields.tracer_2d.data
    rel = float(so.asm.norm_l2(c1 - c0.data) / so.asm.norm_l2(c0.data))
    mass0 = float(so.asm.integrate(c0.data))
    mass1 = float(so.asm.integrate(c1))
    assert rel < 0.2, f"seam-crossing advection error {rel}"
    assert abs(mass1 - mass0) < 1e-10 * abs(mass0)


def test_periodic_swe_uniform_forcing():
    with pytest.raises(AssertionError):
        cpu_mesh(T.PeriodicRectangleMesh, 2, 2, 5e3, 5e3)
    mesh = cpu_mesh(T.PeriodicRectangleMesh, 3, 2, 7.5e3, 5e3)
    asm = T.DGAssembler(mesh, T.FunctionSpace(mesh, "DG", 1))
    opts = SimpleNamespace(
        use_nonlinear_equations=False, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)
    eq = ShallowWaterEquations(mesh, asm, opts, bathymetry=50.0,
                               bnd_conditions={})
    st = swe_state(torch.zeros(mesh.nc, 3, 2, dtype=F64),
                   torch.zeros(mesh.nc, 3, dtype=F64))
    fields = {"momentum_source": tensor([2e-6, 0.0]),
              "lax_friedrichs_velocity_scaling_factor": tensor(1.0)}
    stepper = CrankNicolson(eq, 60.0, semi_implicit=True,
                            solver_parameters=NewtonParameters())
    for _ in range(3):
        st = stepper.advance(0.0, st, fields, fields, {})
    u = st["uv"].numpy()
    e = st["elev"].numpy()
    assert abs(u[..., 0].mean() - 3 * 60.0 * 2e-6) < 1e-12
    assert u[..., 0].std() < 1e-12 and np.abs(u[..., 1]).max() < 1e-12
    assert np.abs(e).max() < 1e-10


# -- tests/test_tracer_cg.py ------------------------------------------------
def run_cg_advection(nx, supg=False, sigma=4e3):
    """``test_tracer_cg.py::run_advection`` through the port."""
    lx, ly = 40e3, 10e3
    u0 = 1.0
    mesh2d = cpu_mesh(T.RectangleMesh, nx, max(2, nx // 4), lx, ly)
    bathy = T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(10.0)
    so = solver2d.FlowSolver2d(mesh2d, bathy)
    o = so.options
    o.tracer_element_family = "cg"
    o.use_supg_tracer = supg
    o.tracer_only = True
    o.horizontal_velocity_scale = u0
    o.horizontal_diffusivity_scale = 0.0
    o.add_tracer_2d("tracer_2d", "Tracer", "Tracer", "-", None)
    o.tracer_timestepper_type = "SSPRK33"
    t_end = 10e3 / u0
    o.timestep = 50.0
    o.simulation_export_time = t_end
    o.simulation_end_time = t_end - 0.1 * o.timestep
    o.no_exports = True
    x0 = 10e3
    so.create_function_spaces()
    Q = so.function_spaces.Q_2d
    c0 = T.Function(Q).interpolate(
        lambda x, y: torch.exp(-(((x - x0) / sigma) ** 2)))
    so.assign_initial_conditions(uv=np.asarray([u0, 0.0]), tracer=c0)
    so.iterate()
    c_end = so.fields.tracer_2d.data.numpy()
    exact = T.Function(Q).interpolate(
        lambda x, y: torch.exp(-(((x - x0 - u0 * t_end) / sigma) ** 2))
    ).data.numpy()
    return float(np.sqrt(np.mean((c_end - exact) ** 2))), c_end


def test_cg_tracer_advection_convergence():
    errs = [run_cg_advection(nx, sigma=2e3)[0] for nx in (20, 40, 80)]
    rates = [math.log(errs[i] / errs[i + 1]) / math.log(2.0)
             for i in range(2)]
    print("port cg tracer errors", errs, "rates", rates)
    assert errs[2] < errs[1] < errs[0]
    assert max(rates) > 1.3


def test_supg_bounded_front():
    err_supg, c_supg = run_cg_advection(60, supg=True, sigma=1.2e3)
    err_gal, c_gal = run_cg_advection(60, supg=False, sigma=1.2e3)
    under_supg = -min(c_supg.min(), 0.0)
    under_gal = -min(c_gal.min(), 0.0)
    assert np.isfinite(c_supg).all()
    assert under_supg < 0.5 * under_gal
    assert err_supg < err_gal


# -- tests/test_swe_channel.py ----------------------------------------------
@pytest.fixture(scope="module")
def channel():
    lx, ly = 40e3, 2e3
    mesh = cpu_mesh(T.RectangleMesh, 25, 2, lx, ly)
    V = T.FunctionSpace(mesh, "DG", 1)
    asm = T.DGAssembler(mesh, V)
    opts = SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)
    eq = ShallowWaterEquations(mesh, asm, opts, bathymetry=20.0,
                               bnd_conditions={})
    elev0 = T.Function(V).interpolate(
        lambda x, y: 2.0 * torch.exp(-(((x - lx / 2) / 4000.0) ** 2)))
    sol = swe_state(torch.zeros(mesh.nc, 3, 2, dtype=F64), elev0.data)
    return mesh, asm, eq, sol


def test_initial_norm_matches_reference(channel):
    """The reference demo's trace: initial eta norm 6251.2574."""
    _, asm, _, sol = channel
    assert float(asm.norm_l2(sol["elev"])) == pytest.approx(6251.2574,
                                                            abs=0.01)


def test_crank_nicolson_demo_trace(channel):
    """6 CN steps of 50 s against the demo's printed norms (rel 2e-3) and
    the closed basin's volume to 1e-6."""
    mesh, asm, eq, sol = channel
    stepper = get_stepper("CrankNicolson", eq, dt=50.0)
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0}
    vol0 = float(asm.integrate(sol["elev"]))
    traces = {2: (5905.0262, 1398.1128), 4: (5193.5227, 2377.8512),
              6: (4656.5334, 2856.5165)}
    s = sol
    for i in range(1, 7):
        s = stepper.advance(0.0, s, fields, fields, {})
        if i in traces:
            eta_ref, uv_ref = traces[i]
            assert float(asm.norm_l2(s["elev"])) == pytest.approx(
                eta_ref, rel=2e-3)
            assert float(asm.norm_l2(s["uv"])) == pytest.approx(uv_ref,
                                                                rel=2e-3)
    assert abs(float(asm.integrate(s["elev"])) - vol0) < 1e-6


def test_ssprk33_stability_and_conservation(channel):
    mesh, asm, eq, sol = channel
    stepper = get_stepper("SSPRK33", eq, dt=5.0)
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0}
    vol0 = float(asm.integrate(sol["elev"]))
    s = sol
    for _ in range(20):
        s = stepper.advance(0.0, s, fields, fields, {})
    eta_norm = float(asm.norm_l2(s["elev"]))
    assert np.isfinite(eta_norm) and eta_norm < 7000.0
    assert abs(float(asm.integrate(s["elev"])) - vol0) < 1e-6


def test_create_iterator():
    def build():
        lx = 20e3
        mesh2d = cpu_mesh(T.RectangleMesh, 10, 2, lx, 4e3)
        so = solver2d.FlowSolver2d(
            mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(20.0))
        o = so.options
        o.timestep = 50.0
        o.simulation_export_time = 200.0
        o.simulation_end_time = 400.0
        o.no_exports = True
        o.swe_timestepper_type = "CrankNicolson"
        e0 = T.Function(T.FunctionSpace(mesh2d, "DG", 1)).interpolate(
            lambda x, y: 0.4 * torch.exp(-(((x - lx / 2) / 3e3) ** 2)))
        so.assign_initial_conditions(elev=e0)
        return so

    so_a = build()
    times = [t for t in so_a.create_iterator()]
    assert len(times) == 8
    assert times[-1] == pytest.approx(400.0)
    assert so_a.i_export == 2
    so_b = build()
    so_b.iterate()
    np.testing.assert_allclose(so_a.fields.elev_2d.data.numpy(),
                               so_b.fields.elev_2d.data.numpy(), atol=1e-12)


# -- tests/test_options_wiring.py -------------------------------------------
def options_channel(tmpdir, **opts):
    """``test_options_wiring.py::_channel`` through the port."""
    mesh2d = cpu_mesh(T.RectangleMesh, 8, 4, 1e4, 5e3)
    so = solver2d.FlowSolver2d(
        mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(20.0))
    o = so.options
    o.timestep = 20.0
    o.simulation_export_time = 100.0
    o.simulation_end_time = 200.0
    o.output_directory = str(tmpdir)
    o.swe_timestepper_type = "CrankNicolson"
    for k, v in opts.items():
        setattr(o, k, v)
    x = mesh2d.coords_np[mesh2d.cells_np][..., 0]
    so.assign_initial_conditions(elev=tensor(0.1 * np.cos(np.pi * x / 1e4)))
    return so


def test_simulation_end_date_overrides_end_time(tmp_path):
    tz = datetime.timezone.utc
    init = datetime.datetime(2026, 1, 1, tzinfo=tz)
    so = options_channel(
        tmp_path, no_exports=True, simulation_initial_date=init,
        simulation_end_date=init + datetime.timedelta(seconds=300.0))
    so.iterate()
    assert so.options.simulation_end_time == 300.0
    assert abs(so.simulation_time - 300.0) < 1e-6


def test_log_output_and_export_diagnostics(tmp_path):
    pytest.importorskip("h5py")
    so = options_channel(tmp_path, log_output=True, export_diagnostics=True,
                         check_volume_conservation_2d=True)
    so.iterate()
    assert os.path.exists(os.path.join(str(tmp_path), "log"))
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "diagnostic_volume2d.hdf5"))


def test_no_exports_suppresses_diagnostics(tmp_path):
    so = options_channel(tmp_path, no_exports=True, export_diagnostics=True,
                         check_volume_conservation_2d=True)
    so.iterate()
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "diagnostic_volume2d.hdf5"))


def test_tracer_picard_iterations_run_and_converge():
    """p = 2, 3 Picard sweeps give the p = 1 tracer to Krylov tolerance;
    a non-CN tracer stepper refuses them."""
    def run(p):
        mesh2d = cpu_mesh(T.RectangleMesh, 12, 4, 1e4, 5e3)
        so = solver2d.FlowSolver2d(
            mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(20.0))
        o = so.options
        o.timestep = 50.0
        o.simulation_export_time = 200.0
        o.simulation_end_time = 200.0
        o.no_exports = True
        o.swe_timestepper_type = "CrankNicolson"
        o.tracer_timestepper_type = "CrankNicolson"
        o.tracer_picard_iterations = p
        o.add_tracer_2d("tracer_2d", "Tracer", "Tracer2d", "tracer_2d",
                        use_conservative_form=True)
        o.horizontal_diffusivity = 1.0
        x = mesh2d.coords_np[mesh2d.cells_np][..., 0]
        so.assign_initial_conditions(
            elev=tensor(0.5 * np.cos(np.pi * x / 1e4)),
            tracer_2d=tensor(1.0 + np.exp(-(((x - 5e3) / 2e3) ** 2))))
        so.iterate()
        return so.fields.tracer_2d.data.numpy()

    c1, c2, c3 = run(1), run(2), run(3)
    assert np.isfinite(c2).all() and np.isfinite(c3).all()
    np.testing.assert_allclose(c2, c1, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(c3, c1, rtol=1e-6, atol=1e-9)
    mesh2d = cpu_mesh(T.RectangleMesh, 8, 4, 1e4, 5e3)
    so = solver2d.FlowSolver2d(
        mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(20.0))
    o = so.options
    o.timestep = 10.0
    o.simulation_export_time = 20.0
    o.simulation_end_time = 20.0
    o.no_exports = True
    o.tracer_timestepper_type = "SSPRK33"
    o.tracer_picard_iterations = 2
    o.add_tracer_2d("tracer_2d", "Tracer", "Tracer2d", "tracer_2d")
    with pytest.raises(NotImplementedError):
        so.assign_initial_conditions(elev=0.0, tracer_2d=1.0)
        so.iterate()


# -- tests/test_native.py ---------------------------------------------------
def test_native_facets_match_numpy(monkeypatch):
    # the port's own builder, whatever this worker's pin_mesh_builders()
    # latched for the parity modules (it puts both packages on their numpy
    # fallback where the reference's library failed to load, as when
    # several workers compile it in place at once)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    if tnative.get_meshbuild() is None:
        pytest.skip("no C++ toolchain")
    m1 = cpu_mesh(T.RectangleMesh, 17, 9, 4.0, 3.0)  # native (default)
    monkeypatch.setenv("THETIS_TPU_NATIVE", "0")
    m2 = cpu_mesh(T.RectangleMesh, 17, 9, 4.0, 3.0)  # numpy
    assert m1.nf == m2.nf
    assert abs(m1.total_area - m2.total_area) < 1e-12
    assert sorted(map(tuple, np.sort(m1.facet_verts_np, 1).tolist())) == \
        sorted(map(tuple, np.sort(m2.facet_verts_np, 1).tolist()))
    assert m1.boundary_len == m2.boundary_len
    monkeypatch.delenv("THETIS_TPU_NATIVE")
    V = T.FunctionSpace(m1, "DG", 1)
    asm = T.DGAssembler(m1, V)
    f = T.Function(V).interpolate(lambda x, y: 1 + 2 * x - y)
    tr = asm.facet_traces(f.data).numpy()
    interior = ~m1.facet_is_boundary_np
    assert np.abs(tr[interior, 0] - tr[interior, 1]).max() < 1e-12
    n, L = m1.facet_normal_np, m1.facet_len_np
    cf, cs = m1.cell_facets_np, m1.cell_sides_np
    sgn = np.where(cs == 0, 1.0, -1.0)
    per_cell = (n[cf] * L[cf][..., None] * sgn[..., None]).sum(axis=1)
    assert np.abs(per_cell).max() < 1e-12


# -- tests/test_multiple_tracers.py -----------------------------------------
def test_multiple_tracers_demo():
    """``demos/demo_2d_multiple_tracers.py`` from its source at regression
    size (``chip_smoke.run_script``): three tracers bounded, the velocity
    of the tracer-only run untouched."""
    so = chip_smoke.run_script("demos/demo_2d_multiple_tracers.py", "cpu",
                               F64).namespace["solver_obj"]
    for label in ("bell_2d", "cone_2d", "slot_cyl_2d"):
        q = so.fields[label].data.numpy()
        assert np.isfinite(q).all()
        assert q.min() > 0.5 and q.max() < 2.5
    assert float(so.asm.norm_l2(so.fields.uv_2d.data)) == pytest.approx(
        0.4082, abs=1e-3)


# -- tests/test_standing_wave.py --------------------------------------------
@pytest.mark.parametrize("timesteps,max_rel_err,stepper", [
    (10, 0.02, "CrankNicolson"), (20, 5e-3, "CrankNicolson"),
    (40, 1.25e-3, "CrankNicolson"),
    pytest.param(20, 5e-3, "PressureProjectionPicard",
                 marks=pytest.mark.slow)])
def test_standing_wave_channel(timesteps, max_rel_err, stepper):
    """One period of the closed channel's standing wave (100 x 1, 100 m):
    the relative L2 error under the reference's bound at each step
    count; CN fully implicit, PPP on dg-cg as the reference runs it."""
    lx, ly, depth = 5e3, 1e3, 100.0
    mesh2d = cpu_mesh(T.RectangleMesh, 100, 1, lx, ly)
    c = math.sqrt(float(T.physical_constants["g_grav"]) * depth)
    dt = 2 * lx / c / timesteps
    so = solver2d.FlowSolver2d(
        mesh2d, T.Function(T.FunctionSpace(mesh2d, "CG", 1)).assign(depth))
    o = so.options
    o.timestep = dt
    o.simulation_export_time = dt * timesteps
    o.simulation_end_time = 2 * lx / c - 0.1 * dt
    o.no_exports = True
    o.swe_timestepper_type = stepper
    if stepper == "CrankNicolson":
        o.swe_timestepper_options.use_semi_implicit_linearization = False
    else:
        o.element_family = "dg-cg"
    so.create_function_spaces()
    h_2d = so.function_spaces.H_2d
    so.assign_initial_conditions(elev=T.Function(h_2d).interpolate(
        lambda x, y: torch.cos(math.pi * x / lx)))
    so.iterate()
    diff = so.fields.elev_2d.data - T.Function(h_2d).interpolate(
        lambda x, y: torch.cos(math.pi * x / lx)).data
    norm = (so.eq_sw.norm_elev(diff) if stepper == "PressureProjectionPicard"
            else so.asm.norm_l2(diff))
    rel_err = float(norm) / math.sqrt(lx * ly)
    print(f"port standing wave {stepper} x{timesteps}: {rel_err:.3e}")
    assert rel_err < max_rel_err
