"""The 2D model of ``thetis_tpu_torch`` as a user drives it, against
``thetis_tpu`` (f64, CPU): the implicit configurations whose
preconditioner the CFL policy picks (BackwardEuler, CrankNicolson with
the coarse correction and with the Schur fieldsplit), ``iterate()`` with
``update_forcings``, a time-step callback and the volume callback (same
iteration counts, export times, ``print_state`` lines and final state),
``create_iterator``, initial-condition interpolation, the demo's body
through the port's facade, the options the port refuses and one step of
each option the 2D slice newly takes.

Tolerances: implicit steps 1e-9 and the explicit ``iterate`` runs 1e-12
of each field's max; ``print_state`` lines equal but for the CPU-time
field; the demo's volume conserved to 1e-10 (relative).  The gradient
of one assembled CN step under the coarse correction through
``differentiable_forward`` is held to ``jax.grad`` of the reference's
(1e-10 of its largest entry; ``test_torch_adjoint_swe.py``'s
:func:`check_assembled_cn_gradient`)."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import thetis_tpu.utils.log as jlog  # noqa: E402
from thetis_tpu.model.callback import (  # noqa: E402
    VolumeConservation2DCallback as JVolume)
from thetis_tpu.utils.constant import Constant as JConstant  # noqa: E402
import thetis_tpu_torch.utils.log as tlog  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from thetis_tpu_torch.model.callback import (  # noqa: E402
    VolumeConservation2DCallback as TVolume)
from thetis_tpu_torch.mesh.sphere import IcosahedralSphereMesh  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402
from thetis_tpu_torch.solvers.newton import (  # noqa: E402
    NewtonParameters as TNewtonParameters)
from thetis_tpu_torch.utils.constant import Constant as TConstant  # noqa: E402
from test_torch_adjoint_swe import check_assembled_cn_gradient  # noqa: E402
from test_torch_flowsolver2d import (  # noqa: E402
    CONFIGS, LX, meshes, one_torch_thread, reference_solver, run_pair)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


#: a KSP budget that solves the small step systems to roundoff
TIGHT = dict(ksp_rtol=1e-12, ksp_max_it=480, gmres_restart=48)


@pytest.mark.parametrize("config", ["backward_euler", "cn_coarse",
                                    "cn_schur"])
def test_policy_preconditioners_match_reference(config):
    """The PC the CFL policy picks, and the step.  The coarse case: the
    port builds the per-field coarse space (the reference's stalls
    FGMRES, ROADMAP C), so both solve the step system to roundoff (the
    reference on plain block-Jacobi) and must reach the same state."""
    coarse = CONFIGS[config][3]
    ref, port = run_pair("rect", config,
                         TIGHT if config == "cn_coarse" else None)
    assert type(ref.timestepper.coarse).__name__ == coarse
    assert type(port.timestepper.coarse).__name__ == coarse
    if config == "cn_coarse":
        assert port.timestepper.coarse.nd_c == 3  # eta, u, v per aggregate
        ref.timestepper.coarse = None
    ref.iterate()
    port.iterate()
    assert (port.iteration, port.i_export) == (ref.iteration, ref.i_export)
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-9)
    limit = 1e-12 if config == "cn_coarse" else 1e-6
    assert port.timestepper.stats["ksp_rel_residual"] < limit


def test_reference_coarse_space_vcycle_matches_reference():
    """With the reference's per-packed-dof coarse space the port's V-cycle
    takes the reference's Krylov path: 3 steps agree though neither
    solve converges (the fault of ROADMAP C)."""
    from thetis_tpu_torch.solvers.assembled import (CoarseCorrection,
                                                    get_coloring)
    ref, port = run_pair("rect", "cn_coarse")
    jcc = ref.timestepper.coarse
    tcc = _reference_space_coarse(port)
    assert isinstance(tcc, CoarseCorrection) and tcc.nd_c == 9
    assert tcc.n_agg == jcc.n_agg
    close(tcc.Ac_inv, jcc.Ac_inv, 1e-10)
    port.timestepper.coarse = tcc
    ref.iterate()
    port.iterate()
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-9)
    assert port.timestepper.stats["ksp_rel_residual"] > 1e-2
    assert get_coloring(port.mesh2d) is get_coloring(port.mesh2d)


def _reference_space_coarse(port):
    """``FlowSolver2d._build_coarse``'s operator with the reference's
    coarse space."""
    from thetis_tpu_torch.solvers.assembled import (
        CoarseCorrection, PackedState, assemble_affine_operator, get_coloring)

    eq = port.eq_sw
    coeff = port.timestepper.theta * port.dt
    zero = {"uv": torch.zeros_like(port.fields.uv_2d.data),
            "elev": torch.zeros_like(port.fields.elev_2d.data)}
    ps = PackedState(zero)
    bz = {m: {k: 0.0 for k in keys} for m, keys in eq.bnd_keys.items()}

    def F(x):
        st = ps.unpack(x)
        r = eq.residual("all", st, zero, {}, {}, bz)
        m = eq.mass_term(st)
        return ps.pack({k: m[k] - coeff * r[k] for k in m})

    blocks, _ = assemble_affine_operator(F, ps.pack(zero), eq.mesh)
    return CoarseCorrection(blocks, get_coloring(eq.mesh)[0], eq.mesh)


def _state_lines(buf, start):
    """print_state lines logged since ``start``, without the CPU time."""
    return [" ".join(line.split()[:-1]) for line in buf[start:]
            if "eta norm" in line]


def test_iterate_with_forcings_and_callbacks():
    """SSPRK33, dt not dividing the export interval (the t_epsilon
    cadence), a Constant drag and BC elevation updated every step, a
    user time-step callback and the volume callback."""
    jm, tm = meshes("rect")
    dt = 0.05 * LX / 12 / np.sqrt(9.81 * 25.0)
    ref = reference_solver(jm, "rect", "ssprk33", dt=dt)
    ref.options.simulation_export_time = 2.5 * dt
    ref.options.simulation_end_time = 8 * dt
    jdrag = JConstant(2.5e-3)
    ref.options.quadratic_drag_coefficient = jdrag
    ref.bnd_functions["shallow_water"][1] = {"elev": JConstant(0.05)}
    port = flowsolver2d_from_reference(ref, tm)
    assert isinstance(port.options.quadratic_drag_coefficient, TConstant)
    logs = {}
    for name, s, volume in (("ref", ref, JVolume), ("port", port, TVolume)):
        drag = s.options.quadratic_drag_coefficient
        bc = s.bnd_functions["shallow_water"][1]["elev"]
        rec = {"forcing": [], "step": [], "export": []}

        def update_forcings(t, drag=drag, bc=bc, rec=rec):
            rec["forcing"].append(t)
            drag.assign(2.5e-3 * (1.0 + t / 100.0))
            bc.assign(0.05 * np.cos(t / 50.0))

        class StepRecorder(volume):
            name = "step_recorder"

            def __call__(self, s=s, rec=rec):
                rec["step"].append((s.iteration, s.simulation_time))
                return super().__call__()

        s.add_callback(StepRecorder(s), "timestep")
        s.add_callback(volume(s), "timestep")
        buf = jlog._memory_buffer if name == "ref" else tlog._memory_buffer
        start = len(buf)
        s.iterate(update_forcings=update_forcings,
                  export_func=lambda s=s, rec=rec: rec["export"].append(
                      (s.i_export, s.iteration, s.simulation_time)))
        rec["lines"] = _state_lines(buf, start)
        rec["volume"] = [line for line in buf[start:]
                         if line.startswith("volume2d")]
        logs[name] = rec
    a, b = logs["ref"], logs["port"]
    assert b["export"] == a["export"] and len(b["export"]) == 3
    assert b["step"] == a["step"] and len(b["step"]) == 8
    np.testing.assert_allclose(b["forcing"], a["forcing"], rtol=1e-15)
    assert b["lines"] == a["lines"] and len(b["lines"]) == 4
    assert len(b["volume"]) == len(a["volume"]) == 8
    assert (port.iteration, port.i_export) == (ref.iteration, ref.i_export)
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-12)


def test_create_iterator_and_scan_cadence():
    """``create_iterator`` yields each step's time; ``iterate`` without
    callbacks runs the export intervals as loops of the reference's scan
    lengths."""
    jm, tm = meshes("periodic")
    ref = reference_solver(jm, "periodic", "ssprk33")
    dt = ref.dt
    ref.options.simulation_export_time = 2 * dt
    ref.options.simulation_end_time = 5 * dt
    port = flowsolver2d_from_reference(ref, tm)
    ref2 = reference_solver(jm, "periodic", "ssprk33")
    ref2.options.simulation_export_time = 2 * dt
    ref2.options.simulation_end_time = 5 * dt
    port2 = flowsolver2d_from_reference(ref2, tm)
    times = {}
    for name, s in (("ref", ref), ("port", port)):
        times[name] = list(s.create_iterator())
    np.testing.assert_allclose(times["port"], times["ref"], rtol=1e-15)
    exports = {}
    for name, s in (("ref", ref2), ("port", port2)):
        rec = []
        s.iterate(export_func=lambda s=s, rec=rec: rec.append(
            (s.i_export, s.iteration)))
        exports[name] = rec
    assert exports["port"] == exports["ref"] == [(1, 2), (2, 4)]
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-12)
        close(port2.fields[key].data, ref2.fields[key].data, 1e-12)


def test_interp_initial_conditions():
    """CG1 Function, CG1 vertex array, DG array and scalar initial
    conditions land on the DG dofs as in the reference (exact)."""
    from thetis_tpu.fem.functionspace import (FunctionSpace as JFS,
                                              Function as JF)
    from thetis_tpu_torch.fem.functionspace import (FunctionSpace as TFS,
                                                    Function as TF)
    jm, tm = meshes("rect")
    ref = reference_solver(jm, "rect", "ssprk33")
    port = flowsolver2d_from_reference(ref, tm)
    v = 1.0 + jm.coords_np[:, 0] / LX
    cases = [
        (JF(JFS(jm, "CG", 1), data=v), TF(TFS(tm, "CG", 1), data=v), None),
        (v, torch.tensor(v), None),
        (0.3, 0.3, None),
        (None, None, np.stack([v, -v], axis=-1)),
    ]
    for je, te, uv in cases:
        if uv is None:
            ref.assign_initial_conditions(elev=je)
            port.assign_initial_conditions(elev=te)
        else:
            ref.assign_initial_conditions(uv=uv)
            port.assign_initial_conditions(uv=torch.tensor(uv))
        for key in ("elev_2d", "uv_2d"):
            np.testing.assert_array_equal(port.fields[key].data.numpy(),
                                          np.asarray(ref.fields[key].data))
    assert port.compute_volume_2d() == pytest.approx(
        ref.compute_volume_2d(), rel=1e-14)


def test_demo_2d_channel_through_the_facade():
    """``demos/demo_2d_channel.py`` with its import line changed to the
    port, its mesh asked for on the CPU (the facade's default is the
    card) and its end time cut to 3 exports."""
    with open(os.path.join(ROOT, "demos", "demo_2d_channel.py")) as f:
        src = f.read()
    assert src.count("from thetis_tpu import *") == 1
    assert src.count("t_end = 2 * 3600") == 1
    assert src.count("RectangleMesh(nx, ny, lx, ly)") == 1
    src = src.replace("from thetis_tpu import *",
                      "from thetis_tpu_torch import *")
    src = src.replace("t_end = 2 * 3600", "t_end = 300.0")
    src = src.replace("RectangleMesh(nx, ny, lx, ly)",
                      'RectangleMesh(nx, ny, lx, ly, device="cpu")')
    ns = {"__name__": "demo"}
    exec(compile(src, "demo_2d_channel.py", "exec"), ns)
    s = ns["solver_obj"]
    assert isinstance(s, FlowSolver2d)
    assert s.mesh2d.device.type == "cpu"
    v0 = s.compute_volume_2d()
    s.iterate()
    assert s.iteration == 6 and s.i_export == 3
    for key in ("elev_2d", "uv_2d"):
        assert bool(torch.isfinite(s.fields[key].data).all())
    assert float(s.fields.uv_2d.data.abs().max()) > 1e-3
    assert abs(s.compute_volume_2d() - v0) <= 1e-10 * abs(v0)


FACADE_MESHES = ("RectangleMesh", "PeriodicRectangleMesh",
                 # the module-level constructors, as a script imports them
                 # from the modules (``thetis_tpu.mesh.generation`` /
                 # ``.mesh2d``): the same rule
                 "generation.RectangleMesh",
                 "generation.PeriodicRectangleMesh", "mesh2d.Mesh2d")


def _mesh_call(gen, **kw):
    """A 4 x 3 rectangle (24 cells) through the constructor ``gen``: a
    facade name, or ``module.name`` under ``thetis_tpu_torch.mesh``."""
    import thetis_tpu_torch as facade
    from thetis_tpu_torch.mesh import generation, mesh2d

    if gen == "mesh2d.Mesh2d":
        rect = generation.RectangleMesh(4, 3, 1e3, 1e3, device="cpu")
        return mesh2d.Mesh2d(rect.coords_np, rect.cells_np, **kw)
    mod, _, name = gen.rpartition(".")
    ctor = getattr({"": facade, "generation": generation}[mod], name)
    return ctor(4, 3, 1e3, 1e3, **kw)


@pytest.mark.parametrize("gen", FACADE_MESHES)
def test_facade_mesh_without_a_card_raises(gen, monkeypatch):
    """Without ``device=`` the meshes go to the card; with no card they
    raise and say how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _mesh_call(gen)


@pytest.mark.parametrize("gen", FACADE_MESHES)
def test_facade_mesh_on_the_cpu_when_asked(gen, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = _mesh_call(gen, device="cpu")
    assert mesh.device.type == "cpu" and mesh.dtype == torch.float64
    assert mesh.nc == 24
    assert mesh.facet_is_interior.device.type == "cpu"


#: the facade's square meshes: (generator, arguments, cells)
FACADE_SQUARES = {"SquareMesh": ((4, 3, 1e3), 24),
                  "UnitSquareMesh": ((4, 4), 32)}


@pytest.mark.parametrize("gen", sorted(FACADE_SQUARES))
def test_facade_square_mesh_goes_to_the_card(gen, monkeypatch):
    """``SquareMesh`` / ``UnitSquareMesh`` follow the facade's rule: the
    card unless ``device=`` says otherwise; without one they raise, and
    give the CPU mesh when asked."""
    import thetis_tpu_torch as facade

    args, nc = FACADE_SQUARES[gen]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(facade, gen)(*args)
    mesh = getattr(facade, gen)(*args, device="cpu")
    assert mesh.device.type == "cpu" and mesh.dtype == torch.float64
    assert mesh.nc == nc
    lx = args[2] if gen == "SquareMesh" else 1.0
    assert np.ptp(mesh.coords_np[:, 0]) == np.ptp(mesh.coords_np[:, 1]) == lx


def _opts_refused():
    """The 2D entry points that raised naming their ROADMAP item until it
    was ported, with that item: A10's HDF5 restart was the last.  Each
    now runs (``test_unported_options_raise``)."""
    return {"load_state": (lambda s: s.load_state(0), "A10")}


REFUSED = _opts_refused()


def _opts_ported():
    """The options of the 2D slices that raised before they were ported,
    each with what one step must show."""
    def sediment(o):
        o.sediment_model_options.solve_suspended_sediment = True

    def exner(o):
        so = o.sediment_model_options
        so.use_exner = True
        so.use_bedload = True
        so.morphological_acceleration_factor = 10.0

    def nh(o):
        o.nh_model_options.solve_nonhydrostatic_pressure = True

    def turbines(o):
        from thetis_tpu_torch.model.turbines import TidalTurbineFarmOptions

        o.tidal_turbine_farms = {"everywhere": [
            TidalTurbineFarmOptions(turbine_density=1e-5)]}

    def tracer(o):
        o.add_tracer_2d("tracer_2d", source=1e-3)

    def tracer_cg(o):
        o.add_tracer_2d("tracer_2d", source=1e-3, diffusivity=1.0)
        o.tracer_element_family = "cg"

    def wetting_drying(o):
        o.use_wetting_and_drying = True

    def wetting_drying_automatic(o):
        o.use_wetting_and_drying = True
        o.use_automatic_wetting_and_drying_alpha = True

    def family(name, degree=None):
        def f(o):
            o.element_family = name
            if degree is not None:
                o.polynomial_degree = degree
        return f

    def stepper(name, **params):
        def f(o):
            o.swe_timestepper_type = name
            if params:
                o.swe_timestepper_options.solver_parameters = \
                    TNewtonParameters(**params)
        return f

    return {"sediment": sediment, "exner": exner, "nh": nh,
            "turbines": turbines, "tracer": tracer, "tracer_cg": tracer_cg,
            "wetting_drying": wetting_drying,
            "wetting_drying_automatic": wetting_drying_automatic,
            "DIRK22": stepper("DIRK22"), "DIRK33": stepper("DIRK33"),
            "PressureProjectionPicard": stepper(
                "PressureProjectionPicard", ksp_rtol=1e-6, ksp_max_it=60,
                gmres_restart=30),
            "SteadyState": stepper("SteadyState", snes_max_it=3,
                                   line_search=True, dense=True),
            "dg-cg": family("dg-cg"), "rt-dg": family("rt-dg"),
            "bdm-dg": family("bdm-dg"), "sphere": family("rt-dg", 0)}


PORTED = _opts_ported()
#: the state each ported option's step must move, and what it starts from
#: besides the elevation hump (a deposit; a 1.5 m/s flow over the bed)
MOVED = {"sediment": "sediment_2d", "exner": "bathymetry", "nh": "q",
         "turbines": "uv", "tracer": "tracer_2d", "tracer_cg": "tracer_2d"}
START = {"sediment": dict(sediment=1e-3), "exner": dict(uv=torch.tensor(
    [1.5, 0.0], dtype=torch.float64)), "tracer": dict(tracer_2d=1.0),
    "tracer_cg": dict(tracer_2d=1.0)}


def _port_solver(**opts):
    _, tm = meshes("rect")
    s = FlowSolver2d(tm, 20.0)
    s.options.no_exports = True
    for k, v in opts.items():
        setattr(s.options, k, v)
    return s


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_unported_options_raise(what, tmp_path):
    """Every element family and mesh of the reference is ported (A8), the
    adjoint (A9) and I/O (A10): the entry points that raised naming their
    item run.  ``load_state(0)`` restores the checkpoint of the initial
    export into a solver stepped on (parity with the reference in
    ``test_torch_io_restart.py``)."""
    s = _port_solver(no_exports=False, output_directory=str(tmp_path),
                     fields_to_export=[], timestep=1.0)
    s.initialize()
    s.assign_initial_conditions(elev=0.1)
    start = {k: v.clone() for k, v in s._get_state().items()}
    s.export()
    s.options.simulation_end_time = 2.0
    s.iterate()
    assert s.simulation_time == 2.0
    call, item = REFUSED[what]
    assert item == "A10"
    call(s)
    assert s.simulation_time == 0.0 and s.i_export == 1
    for k, v in s._get_state().items():
        assert torch.equal(v, start[k]), k


@pytest.mark.parametrize("what", sorted(PORTED))
def test_ported_options_step(what):
    """Each option the 2D slices ported is taken (no raise) and one step
    through ``iterate()`` moves the state and keeps it finite; parity
    with the reference is in ``test_torch_model2d_tracers.py``,
    ``test_torch_wetting_drying.py``, ``test_torch_steppers2d.py``,
    ``test_torch_sediment.py``, ``test_torch_turbines.py``,
    ``test_torch_nh.py``, ``test_torch_dgcg.py``, ``test_torch_hdiv.py``
    and ``test_torch_sphere.py``."""
    if what == "sphere":
        # an rt-dg (RT1 x P0) hump on a refinement-1 Earth
        tm = IcosahedralSphereMesh(6371220.0, 1, device="cpu")
        s = FlowSolver2d(tm, 1000.0)
    else:
        _, tm = meshes("rect")
        s = FlowSolver2d(tm, 20.0 + 5.0 * torch.as_tensor(
            tm.coords_np[:, 1]) / 5e3)
    o = s.options
    o.no_exports = True
    o.timestep = 60.0
    o.simulation_export_time = 60.0
    o.simulation_end_time = 60.0
    PORTED[what](o)
    s.bnd_functions["shallow_water"][1] = {"elev": 0.05}
    s.bnd_functions["tracer"][1] = {"value": 2.0}
    s.create_function_spaces()
    if what == "sphere":
        z = torch.as_tensor(tm.cell_midpoints()[:, 2])[:, None] / 6371220.0
        elev = 0.3 * torch.exp(-((z - 0.5) / 0.2) ** 2)
        o.coriolis_frequency = torch.as_tensor(1.46e-4 * tm.coords_np[:, 2]
                                               / 6371220.0)
    else:
        # the elevation space's nodes: P1DG, P2 CG (dg-cg) or P1DG at
        # degree-5 quadrature (RT2 / BDM2 x P1DG)
        x = s.function_spaces.H_2d.dof_coords()
        elev = 0.3 * torch.exp(-((x[..., 0] - 5e3) / 2e3) ** 2)
    kw = START.get(what, {})
    s.assign_initial_conditions(elev=elev, **kw)
    start = {k: v.clone() for k, v in s._get_state().items()}
    s.iterate()
    assert s.iteration == 1
    for k, v in s._get_state().items():
        assert bool(torch.isfinite(v).all()), k
    moved = MOVED.get(what, "elev")
    assert float((s._get_state()[moved] - start[moved]).abs().max()) > 1e-6
    if what == "turbines":
        assert [n for n, _, _ in s.eq_sw.terms].count("TurbineDragTerm") == 1
    if what in ("dg-cg", "rt-dg", "bdm-dg", "sphere"):
        assert not getattr(s.timestepper, "assembled_solve", False)
        assert s.eq_sw.mesh is tm
    if what.startswith("wetting_drying"):
        assert s.eq_sw.depth.use_wetting_and_drying
        assert not getattr(s.timestepper, "assembled_solve", False)
        if what.endswith("automatic"):
            assert s.options.wetting_and_drying_alpha.data.shape == (tm.nv,)


@pytest.mark.parametrize("what", ["exporters", "load_state", "hdf5"])
def test_unported_entry_points_raise(what, tmp_path):
    """A10's entry points, which raised until they were ported, run: the
    exporters write the VTK series and the HDF5 checkpoints,
    ``load_state`` restores a checkpoint, and a monitor writes its HDF5
    series (parity in ``test_torch_io_*.py``)."""
    s = _port_solver(no_exports=False, output_directory=str(tmp_path),
                     timestep=1.0)
    s.initialize()
    if what == "exporters":
        assert sorted(s.exporters) == ["hdf5", "vtk"]
        s.export()
        assert sorted(os.listdir(tmp_path)) == ["Elevation2d", "Velocity2d",
                                                "hdf5"]
        assert sorted(os.listdir(tmp_path / "hdf5")) == [
            "Elevation2d_00000.h5", "Velocity2d_00000.h5", "mesh.h5"]
    elif what == "load_state":
        s.assign_initial_conditions(elev=0.25)
        s.export()
        s.fields.elev_2d.data = torch.zeros_like(s.fields.elev_2d.data)
        s.load_state(0)
        assert float(s.fields.elev_2d.data.min()) == 0.25
    else:
        cb = TVolume(s, export_to_hdf5=True)
        s.simulation_time = 3.0
        cb.evaluate()
        import h5py

        with h5py.File(tmp_path / "diagnostic_volume2d.hdf5") as f:
            assert f["time"][:].tolist() == [[3.0]]
            assert f["relative_difference"][:].tolist() == [[0.0]]


@pytest.mark.parametrize("control", ["initial_elev", "initial_uv",
                                     "quadratic_drag_coefficient"])
def test_differentiable_forward_runs(control):
    """The adjoint's entry point (ROADMAP A9, which raised before it was
    ported): on the default semi-implicit CN of the 12x6 rectangle, two
    steps, the gradient of the domain integral of u plus the squared L2
    norm of the elevation is finite and agrees with a central difference
    along a seeded direction to 1e-6 (the solves stop at 1e-10); parity
    with the reference is in ``test_torch_adjoint_*.py``."""
    s = _port_solver()
    s.options.timestep = 300.0
    s.options.quadratic_drag_coefficient = 2.5e-3
    s.options.swe_timestepper_options.solver_parameters = \
        TNewtonParameters(ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=40)
    s.initialize()
    x = s.function_spaces.H_2d.dof_coords()
    s.assign_initial_conditions(elev=0.3 * torch.exp(
        -((x[..., 0] - LX / 2) / 2e3) ** 2))
    asm = s.asm
    fwd = s.differentiable_forward(
        [control], n_steps=2,
        terminal_functional=lambda st: asm.integrate(st["uv"][..., 0])
        + asm.norm_l2(st["elev"]) ** 2)
    rng = np.random.default_rng(4)
    if control == "quadratic_drag_coefficient":
        c = torch.full((s.mesh2d.nv,), 2.5e-3, dtype=torch.float64)
        d = torch.tensor(1e-3 * rng.random(c.shape))
    else:
        c = s._get_state()[control.split("_")[1]].clone()
        d = torch.tensor(0.01 * rng.standard_normal(tuple(c.shape)))
    ct = c.clone().requires_grad_(True)
    J = fwd(ct)
    (g,) = torch.autograd.grad(J, ct)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
    h = 1e-3
    with torch.no_grad():
        fd = (float(fwd(c + h * d)) - float(fwd(c - h * d))) / (2 * h)
    assert float((g * d).sum()) == pytest.approx(fd, rel=1e-6)


def test_assembled_cn_coarse_gradient_matches_reference(monkeypatch):
    check_assembled_cn_gradient("cn_coarse", monkeypatch)
