"""The time steppers of ``thetis_tpu_torch`` that the 2D model gained with
the DIRK, IMEX, pressure-projection and steady-state schemes, against
``thetis_tpu`` (f64, CPU), from the same seeded numpy inputs:

* one SWE step of each stepper class on a 5x4 rectangle with an ``elev``
  boundary: ``DIRKUForm`` (DIRK22, DIRK33) on the assembled ring
  operator and by matrix-free Newton (DIRK22 fully nonlinear, DIRK33
  semi-implicit),
  ``DIRKGeneric`` (DIRK23, an ESDIRK), the IMEX pairs (SSPIMEX,
  IMEXEuler) and ``PressureProjectionPicard``;
* through ``FlowSolver2d``: DIRK22 under the CFL policy (its coarse
  correction built from a_ii dt) and SteadyState at 8x4 (the dense-LU,
  line-searched Newton);
* the oscillator ODE of ``tests/test_convergence_ode.py`` through the
  port: every scheme's order, and its n = 16 solution against the
  reference's;
* PressureProjectionPicard on the standing wave of
  ``tests/test_standing_wave.py`` at 20 steps (the reference's bound,
  5e-3; dg-dg, where the wave-Schur PC is off).

Tolerances: SWE steps 1e-9 of each field's max (as
``test_torch_flowsolver2d.py``'s implicit steps);
the ODE solutions 1e-12; orders as the reference test (expected - 0.25)."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats as sstats  # noqa: E402

from thetis_tpu.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations as JSWE)
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JSolver  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
from thetis_tpu.timeintegration.implicitexplicit import (  # noqa: E402
    get_imex_stepper as j_get_imex)
from thetis_tpu.timeintegration.steppers import (  # noqa: E402
    get_stepper as j_get_stepper)
from thetis_tpu_torch.config import physical_constants  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations as TSWE)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TFS)
from thetis_tpu_torch.interop import (  # noqa: E402
    fields_from_numpy, flowsolver2d_from_reference, state_from_numpy,
    state_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402
from thetis_tpu_torch.solvers.newton import (  # noqa: E402
    NewtonParameters as TNP)
from thetis_tpu_torch.timeintegration import steppers as tsteppers  # noqa: E402
from thetis_tpu_torch.timeintegration.implicitexplicit import (  # noqa: E402
    get_imex_stepper as t_get_imex)

F64 = torch.float64
LX, LY = 1e4, 8e3
BCS = {1: {"elev": 0.05}}
#: a Krylov/Newton budget that solves the small step systems to roundoff
TIGHT = dict(snes_rtol=1e-12, snes_atol=1e-14, snes_max_it=20,
             ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=50)
#: the stepper cases' budget: at most two FGMRES cycles a linear solve
#: (both packages take the same Krylov path, so a solve that stops short
#: still gives the same step; each Krylov iteration is a forward-mode
#: Jacobian product, ~40 ms on one CPU thread at this size)
STEP = dict(snes_rtol=1e-10, snes_max_it=6, ksp_rtol=1e-10, ksp_max_it=60,
            gmres_restart=30)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def swe_opts():
    return SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)


@pytest.fixture(scope="module")
def swe_pair():
    jm = jgen.RectangleMesh(5, 4, LX, LY)
    tm = tgen.RectangleMesh(5, 4, LX, LY, device="cpu", dtype=F64)
    rng = np.random.default_rng(9)
    bathy = 20.0 + 5.0 * jm.coords_np[:, 1] / LY
    jeq = JSWE(jm, JAsm(jm, JFS(jm, "DG", 1)), swe_opts(),
               jnp.asarray(bathy), bnd_conditions=BCS)
    teq = TSWE(tm, TAsm(tm, TFS(tm, "DG", 1)), swe_opts(),
               torch.as_tensor(bathy), bnd_conditions=BCS)
    x = jm.coords_np[jm.cells_np]
    state = {"elev": 0.5 * np.exp(-((x[..., 0] - LX / 2) / 2e3) ** 2),
             "uv": 0.05 * rng.standard_normal((jm.nc, 3, 2))}
    fields = {"lax_friedrichs_velocity_scaling_factor": 1.0,
              "quadratic_drag_coefficient": 2.5e-3}
    # implicit wave CFL ~1.5 by the smallest edge
    dt = 1.5 * float(jm.cell_hmin_np.min()) / np.sqrt(9.81 * 25.0)
    return jeq, teq, state, fields, dt


#: case -> (stepper name, keyword arguments)
CASES = {
    "DIRK22-assembled": ("DIRK22", dict(semi_implicit=True,
                                        assembled_solve=True)),
    "DIRK33-assembled": ("DIRK33", dict(semi_implicit=True,
                                        assembled_solve=True)),
    "DIRK22-newton": ("DIRK22", dict(semi_implicit=False)),
    "DIRK33-newton": ("DIRK33", dict(semi_implicit=True)),
    "DIRK23": ("DIRK23", dict(semi_implicit=True)),
    "ESDIRKTrapezoid": ("ESDIRKTrapezoid", dict(semi_implicit=False)),
    "SSPIMEX": ("SSPIMEX", dict(semi_implicit=True)),
    "IMEXEuler": ("IMEXEuler", dict(semi_implicit=True)),
    "PressureProjectionPicard": ("PressureProjectionPicard", {}),
}


def steppers(case, jeq, teq, dt):
    name, kw = CASES[case]
    tkw = dict(kw, solver_parameters=TNP(**STEP))
    jkw = dict(kw, solver_parameters=JNP(**STEP))
    return (j_get_stepper(name, jeq, dt, **jkw),
            tsteppers.get_stepper(name, teq, dt, **tkw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_swe_step_matches_reference(swe_pair, case, monkeypatch):
    jeq, teq, state, fields, dt = swe_pair
    jst, tst = steppers(case, jeq, teq, dt)
    assert type(tst).__name__ == type(jst).__name__
    calls = []
    orig = teq.assemble_operator_blocks
    monkeypatch.setattr(teq, "assemble_operator_blocks",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = fields_from_numpy(fields, "cpu", F64)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    step = jax.jit(lambda s: jst.advance(0.0, s, jf, jf, BCS))
    want = step(js)
    got = state_to_numpy(tst.advance(0.0, state_from_numpy(state, "cpu",
                                                           F64),
                                     tf, tf, BCS))
    for k in ("uv", "elev"):
        close(got[k], want[k], 1e-9)
    assert np.abs(got["elev"] - state["elev"]).max() > 1e-4
    st = tst.stats
    implicit = {"DIRK22": 2, "DIRK33": 3, "DIRK23": 2, "ESDIRKTrapezoid": 1,
                "SSPIMEX": 3, "IMEXEuler": 1, "PressureProjectionPicard": 4}
    assert st["stages"] == implicit[CASES[case][0]]
    if not CASES[case][1].get("semi_implicit", True):
        assert st["snes_rel_residual"] < 1e-10
    if case.endswith("assembled"):
        # one analytic assembly a step: the diagonal a_ii is constant
        assert len(calls) == 1 and tst.assembled_solve
        assert st["newton_iterations"] == st["stages"]
        assert st["ksp_rel_residual"] < 1e-10
    else:
        assert not calls


def test_get_stepper_vocabulary(swe_pair):
    """Every name of the reference's ``get_stepper`` gives the port the
    same class; an unknown name raises."""
    jeq, teq, _, _, dt = swe_pair
    names = ["ForwardEuler", "SSPRK33", "CrankNicolson", "BackwardEuler",
             "DIRK22", "DIRK33", "DIRK23", "DIRK43", "DIRKLSPUM2",
             "DIRKLPUM2", "ESDIRKMidpoint", "ESDIRKTrapezoid",
             "ImplicitMidpoint", "ERKMidpoint", "ERKLSPUM2", "ERKLPUM2",
             "SteadyState", "SSPIMEX", "IMEXLPUM2", "IMEXLSPUM2",
             "IMEXEuler", "IMEXMidpoint", "PressureProjectionPicard"]
    for name in names:
        j = type(j_get_stepper(name, jeq, dt)).__name__
        t = type(tsteppers.get_stepper(name, teq, dt)).__name__
        assert t == j, name
    with pytest.raises(ValueError, match="unknown time stepper"):
        tsteppers.get_stepper("RK4", teq, dt)


def test_ppp_switches_off_the_schur_pc_on_dg_dg(swe_pair, caplog):
    _, teq, _, _, dt = swe_pair
    with caplog.at_level("INFO"):
        st = tsteppers.get_stepper("PressureProjectionPicard", teq, dt)
    assert "disabling the wave-Schur preconditioner" in caplog.text
    assert not st.use_schur_pc
    p = st.params
    assert (p.ksp_rtol, p.ksp_max_it, p.gmres_restart) == (1e-10, 240, 60)
    assert p.snes_max_it == 1 and st.params_mom.snes_max_it == 1


# ------------------------------------------------------- FlowSolver2d
def model_pair(jm, tm, stepper, dt, setup=None):
    bathy = 20.0 + 5.0 * jm.coords_np[:, 1] / jm.coords_np[:, 1].max()
    s = JSolver(jm, bathy)
    o = s.options
    o.swe_timestepper_type = stepper
    o.timestep = dt
    o.simulation_export_time = dt
    o.simulation_end_time = dt
    o.no_exports = True
    if setup is not None:
        setup(s)
    rng = np.random.default_rng(13)
    x = jm.coords_np[jm.cells_np]
    xmax = jm.coords_np[:, 0].max()
    s.assign_initial_conditions(
        elev=0.3 * np.exp(-((x[..., 0] - xmax / 2) / (0.2 * xmax)) ** 2),
        uv=0.05 * rng.standard_normal((jm.nc, 3, 2)))
    return s, flowsolver2d_from_reference(s, tm)


def test_dirk22_policy_through_the_model():
    """DIRK22 semi-implicit through ``FlowSolver2d``: the policy's
    coarse correction from a_ii dt (wave CFL 4-8), built by both."""
    jm = jgen.RectangleMesh(12, 6, LX, LY)
    tm = tgen.RectangleMesh(12, 6, LX, LY, device="cpu", dtype=F64)
    hmin = float(jm.cell_hmin_np.min())
    # a_ii = 1 - 1/sqrt(2): CFL = a_ii dt sqrt(g H) / hmin = 6
    dt = 6.0 * hmin / np.sqrt(9.81 * 25.0) / (1 - 1 / np.sqrt(2))

    def setup(s):
        s.options.swe_timestepper_options.solver_parameters = JNP(**TIGHT)
        s.bnd_functions["shallow_water"][1] = {"elev": 0.05}

    ref, port = model_pair(jm, tm, "DIRK22", dt, setup)
    cfl = port._wave_cfl(float(port.timestepper.a[-1][-1]) * dt)
    assert 4.0 < cfl < 8.0
    assert type(ref.timestepper.coarse).__name__ == "CoarseCorrection"
    assert type(port.timestepper.coarse).__name__ == "CoarseCorrection"
    assert port.timestepper.assembled_solve
    # the reference's per-packed-dof coarse space stalls FGMRES here
    # (ROADMAP C): both solve on plain block-Jacobi for the comparison
    ref.timestepper.coarse = None
    port.timestepper.coarse = None
    ref.iterate()
    port.iterate()
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-9)
    assert port.timestepper.stats["ksp_rel_residual"] < 1e-11


def test_steady_state_through_the_model():
    """SteadyState at 8x4 (the adjoint test's set-up: viscosity, a drag
    bump, an inflow and an open outflow), one dense-LU Newton solve."""
    jm = jgen.RectangleMesh(8, 4, 100.0, 50.0)
    tm = tgen.RectangleMesh(8, 4, 100.0, 50.0, device="cpu", dtype=F64)

    def setup(s):
        o = s.options
        o.horizontal_viscosity = 2.0
        x = s.mesh2d.coords_np
        o.quadratic_drag_coefficient = jnp.asarray(
            12.0 * np.exp(-((x[:, 0] - 50.0) ** 2 + (x[:, 1] - 25.0) ** 2)
                          / 20.0**2) + 0.0025)
        s.bnd_functions["shallow_water"] = {1: {"un": -1.0},
                                            2: {"elev": 0.0}}

    ref, port = model_pair(jm, tm, "SteadyState", 0.5, setup)
    assert type(port.timestepper).__name__ == "SteadyState"
    p = port.timestepper.params
    assert p.dense and p.line_search
    ref.iterate()
    port.iterate()
    for key in ("elev_2d", "uv_2d"):
        close(port.fields[key].data, ref.fields[key].data, 1e-9)
    st = port.timestepper.stats
    assert st["newton_iterations"] >= 2 and st["snes_rel_residual"] < 1e-8


# ------------------------------------------------------------- the ODE
OMEGA = 2.0
ODE_SCHEMES = [
    ("ForwardEuler", 1.0, False), ("BackwardEuler", 1.0, False),
    ("CrankNicolson", 2.0, False), ("SSPRK33", 3.0, False),
    ("DIRK22", 2.0, False), ("DIRK23", 3.0, False), ("DIRK33", 3.0, False),
    ("DIRK43", 3.0, False), ("DIRKLSPUM2", 2.0, False),
    ("DIRKLPUM2", 2.0, False), ("ImplicitMidpoint", 2.0, False),
    ("ESDIRKMidpoint", 2.0, False), ("ESDIRKTrapezoid", 2.0, False),
    ("ERKMidpoint", 2.0, False), ("ERKLSPUM2", 2.0, False),
    ("ERKLPUM2", 2.0, False), ("SSPIMEX", 2.0, True),
    ("IMEXLSPUM2", 2.0, True), ("IMEXMidpoint", 2.0, True),
    ("IMEXEuler", 1.0, True),
]
_IMPLICIT = ("CrankNicolson", "BackwardEuler", "DIRK22", "DIRK23", "DIRK33",
             "DIRK43", "DIRKLSPUM2", "DIRKLPUM2", "ESDIRKMidpoint",
             "ESDIRKTrapezoid", "ImplicitMidpoint")


class Oscillator:
    """du/dt = omega v, dv/dt = -omega u, the two rows tagged
    'explicit' / 'implicit' (``tests/test_convergence_ode.py``), on
    either package's arrays (``zeros_like`` from the state's module)."""

    def __init__(self, lib):
        self.lib = lib

    def residual(self, label, sol, sol_old, fields, fields_old, bnd):
        if isinstance(label, str):
            labels = ({"explicit", "implicit", "source", "nonlinear"}
                      if label == "all" else {label})
        else:
            labels = set(label)
        u, v = sol["u"], sol["v"]
        r_u = self.lib.zeros_like(u)
        r_v = self.lib.zeros_like(v)
        if "explicit" in labels:
            r_u = r_u + OMEGA * v
        if "implicit" in labels:
            r_v = r_v - OMEGA * u
        return {"u": r_u, "v": r_v}

    def mass_term(self, sol):
        return dict(sol)

    def mass_inverse(self, r):
        return dict(r)


#: the reference test's tolerances; two Krylov iterations solve the 2x2
#: systems exactly
ODE_PARAMS = dict(snes_rtol=1e-13, snes_atol=1e-15, ksp_rtol=1e-13,
                  snes_max_it=20, gmres_restart=2, ksp_max_it=4)


def ode_stepper(name, imex, dt, torch_port):
    eq = Oscillator(torch if torch_port else jnp)
    P = TNP if torch_port else JNP
    getter = ((t_get_imex if imex else tsteppers.get_stepper) if torch_port
              else (j_get_imex if imex else j_get_stepper))
    kw = {}
    if imex or name in _IMPLICIT:
        kw["solver_parameters"] = P(**ODE_PARAMS)
    return getter(name, eq, dt, **kw)


def ode_run(name, n, imex):
    st = ode_stepper(name, imex, 2.0 / n, True)
    sol = {"u": torch.tensor([1.0], dtype=F64),
           "v": torch.tensor([0.0], dtype=F64)}
    for _ in range(n):
        sol = st.advance(0.0, sol, {}, {}, {})
    return sol


@pytest.mark.parametrize("name,expected,imex", ODE_SCHEMES)
def test_ode_order_and_reference(name, expected, imex):
    ns = [16, 32, 64]
    errs = []
    for n in ns:
        sol = ode_run(name, n, imex)
        errs.append(math.hypot(float(sol["u"][0]) - math.cos(OMEGA * 2.0),
                               float(sol["v"][0]) + math.sin(OMEGA * 2.0)))
        if n == 16:
            first = sol
    order = -sstats.linregress(np.log(ns), np.log(errs)).slope
    assert order > expected - 0.25, f"{name} order {order} < {expected}"
    jst = ode_stepper(name, imex, 2.0 / 16, False)
    step = jax.jit(lambda s: jst.advance(0.0, s, {}, {}, {}))
    ref = {"u": jnp.asarray([1.0]), "v": jnp.asarray([0.0])}
    for _ in range(16):
        ref = step(ref)
    for k in ("u", "v"):
        np.testing.assert_allclose(first[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------- the standing wave
def test_ppp_standing_wave():
    """One period of the closed-channel standing wave (100 x 1, depth
    100 m) in 20 PressureProjectionPicard steps through the port (dg-dg:
    the mass-preconditioned corrector), relative L2 error <= 5e-3, the
    reference test's bound at this step count (~45 s on one CPU
    thread: 11,520 Jacobian products)."""
    lx, ly, n, depth = 5e3, 1e3, 20, 100.0
    mesh = tgen.RectangleMesh(100, 1, lx, ly, device="cpu", dtype=F64)
    c = math.sqrt(float(physical_constants["g_grav"]) * depth)
    period = 2 * lx / c
    dt = period / n
    s = FlowSolver2d(mesh, TFunction(TFS(mesh, "CG", 1)).assign(depth))
    o = s.options
    o.timestep = dt
    o.simulation_export_time = dt * n
    o.simulation_end_time = period - 0.1 * dt
    o.no_exports = True
    o.swe_timestepper_type = "PressureProjectionPicard"
    s.create_function_spaces()
    H = s.function_spaces.H_2d
    e0 = TFunction(H).interpolate(lambda x, y: torch.cos(math.pi * x / lx))
    s.assign_initial_conditions(elev=e0)
    s.iterate()
    assert s.iteration == n
    rel = float(s.asm.norm_l2(s.fields.elev_2d.data - e0.data)) / math.sqrt(
        lx * ly)
    assert rel < 5e-3, rel
