"""The reference's 2D convergence suites through ``thetis_tpu_torch``, on
the CPU in f64, each under the reference test's own ladder and bound:

* ``tests/test_swe_mms.py``: the steady manufactured solutions (basic,
  Coriolis, viscosity) on 8 / 16 / 32, 240 semi-implicit BackwardEuler
  steps (the port's assembled solve), elevation and velocity slopes
  > 1.5; the run is ``chip_smoke.swe_mms_error``, which phase 32 runs on
  the card, given the reference module's sympy-derived solution here;
* ``tests/test_tracer_mes.py``: DG tracer advection on refinements
  1 / 2 / 4 (slope > 1.6) and diffusion on 1 / 2 / 3 (> 1.44),
  ``TracerEquation2D`` stepped by ``SSPRK33`` in a Python loop;
* ``tests/test_swe_p2.py``: the degree-2 standing wave (8 / 16 / 32,
  slopes > 2.5), P2 against P1 at 16, the degree-2 tracer's order.

Each suite has a parity case: at its coarsest rung the port's error norm
equals the reference's to rtol 1e-9 (f64).  The reference module is
loaded from its file for its constants, its runs and its sources.  Which
tests are ``slow`` follows the port's run time on the CPU: the SWE MMS
ladders take 2-3 min a case, their parity case ~55 s (the reference's
first compile ~30 s of it) and the check of phase 32's CPU errors 30-40 s
a case; the rest take seconds."""
import functools
import importlib.util
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import chip_smoke  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.tracer_2d import (  # noqa: E402
    TracerEquation2D as TTracer)
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    SSPRK33 as TSSPRK33)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
PARITY_RTOL = 1e-9


@functools.lru_cache(maxsize=None)
def reference_suite(name):
    """The reference's test module ``tests/<name>.py``, loaded from its
    file (its constants, its runs and its manufactured sources)."""
    path = os.path.join(os.path.dirname(__file__), name + ".py")
    spec = importlib.util.spec_from_file_location("_ref_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_parity(port, ref):
    """Each error norm of the port's run equals the reference's."""
    np.testing.assert_allclose(np.asarray(port, dtype=float),
                               np.asarray(ref, dtype=float),
                               rtol=PARITY_RTOL, atol=0.0)


# -- tests/test_swe_mms.py --------------------------------------------------
SWE_MMS_CASES = ("basic", "coriolis", "viscosity")


@pytest.mark.parametrize("case", SWE_MMS_CASES)
def test_swe_mms_solution_is_the_references(case):
    """``chip_smoke.swe_mms_manufactured`` (phase 32's copy, written out
    by hand: the card's machine has no sympy) is the reference test's
    sympy-derived solution and sources, at seeded points of the basin."""
    mms = reference_suite("test_swe_mms")
    ours, ref = chip_smoke.swe_mms_manufactured(case), mms._CASES[case]
    assert set(ours) == set(ref)
    rng = np.random.default_rng(16)
    x, y = rng.uniform(0.0, mms.LX, (2, 500))
    for key, fn in ref.items():
        if fn is None:
            assert ours[key] is None, key
            continue
        want = np.broadcast_to(fn(x, y), x.shape)
        got = np.broadcast_to(ours[key](x, y), x.shape)
        np.testing.assert_allclose(got, want, rtol=0.0,
                                   atol=1e-13 * np.abs(want).max())


@pytest.mark.slow
@pytest.mark.parametrize("case", SWE_MMS_CASES)
def test_swe_steady_mms_convergence(case):
    """``test_swe_mms.py::test_swe_steady_mms_convergence``: the ladder
    8 / 16 / 32 and slope > 2 (1 - 0.25) for the elevation and the
    velocity."""
    mms = reference_suite("test_swe_mms")
    ns = [8, 16, 32]
    errs = [chip_smoke.swe_mms_error(n, case, "cpu", mms._CASES[case])[0]
            for n in ns]
    h = np.log([mms.LX / n for n in ns])
    for i, fieldname in enumerate(["elev", "uv"]):
        slope = stats.linregress(h, np.log([e[i] for e in errs])).slope
        print(f"port SWE MMS {case}/{fieldname}: errors "
              f"{[e[i] for e in errs]}, slope {slope:.4f}")
        assert slope > 2.0 * (1 - 0.25), (
            f"{case}/{fieldname}: slope {slope} < 2")


@pytest.mark.slow
def test_swe_mms_coarsest_rung_matches_reference():
    """At nx 8 (``basic``) the port's elevation and velocity errors are
    the reference's ``_run_swe(8, "basic")``."""
    mms = reference_suite("test_swe_mms")
    port = chip_smoke.swe_mms_error(8, "basic", "cpu", mms._CASES["basic"])
    assert_parity(port[0], mms._run_swe(8, "basic"))


@pytest.mark.slow
@pytest.mark.parametrize("case", SWE_MMS_CASES)
def test_swe_mms_cpu_errors_are_the_cards_oracle(case):
    """``chip_smoke.MMS_CPU_ERRORS``, which phase 32 holds the card's
    coarsest-rung errors to, is what ``chip_smoke.swe_mms_error`` gives
    on the CPU at that rung (the run held to the reference above)."""
    nx = chip_smoke.MMS_LADDER[0]
    errors, _ = chip_smoke.swe_mms_error(nx, case, "cpu")
    np.testing.assert_allclose(errors, chip_smoke.MMS_CPU_ERRORS[case],
                               rtol=1e-12, atol=0.0)


# -- tests/test_tracer_mes.py -----------------------------------------------
def tracer_opts():
    return SimpleNamespace(use_lax_friedrichs_tracer=True,
                           sipg_factor_tracer=1.0, tracer={})


def march(stepper, sol, fields, bnd, nsteps):
    for _ in range(nsteps):
        sol = stepper.advance(0.0, sol, fields, fields, bnd)
    return sol


def port_advection(refinement):
    """``test_tracer_mes.py::run_advection`` through the port: a cosine
    hill carried through a channel at 1 m/s, against its translate."""
    n = 16 * refinement
    lx, ly = 1.0, 0.25
    mesh = T.RectangleMesh(n, max(2, n // 4), lx, ly, device="cpu",
                           dtype=F64)
    V = T.FunctionSpace(mesh, "DG", 1)
    asm = T.DGAssembler(mesh, V)
    u0, t_end = 1.0, 0.25

    def exact(x, y, t):
        r = torch.abs(x - u0 * t - 0.25) / 0.15
        return torch.where(r < 1.0, 0.5 * (1 + torch.cos(math.pi * r)),
                           torch.zeros_like(r))

    def bnd():
        return {1: {"value": 0.0,
                    "uv": torch.tensor([u0, 0.0], dtype=F64)}}

    eq = TTracer(mesh, asm, tracer_opts(), bathymetry=1.0,
                 labels=["tracer_2d"], bnd_conditions=bnd())
    uv = torch.tensor([u0, 0.0], dtype=F64).expand(mesh.nc, 3, 2)
    fields = {"uv_2d": uv, "elev_2d": 0.0,
              "lax_friedrichs_tracer_scaling_factor": 1.0}
    c0 = T.Function(V).interpolate(lambda x, y: exact(x, y, 0.0))
    dt = 0.2 / (16 * refinement) / u0 * 0.25
    nsteps = int(round(t_end / dt))
    final = march(TSSPRK33(eq, t_end / nsteps), {"tracer_2d": c0.data},
                  fields, bnd(), nsteps)
    cex = T.Function(V).interpolate(lambda x, y: exact(x, y, t_end))
    return float(asm.norm_l2(final["tracer_2d"] - cex.data))


def port_diffusion(refinement):
    """``test_tracer_mes.py::run_diffusion`` through the port: an erf
    front diffusing in a closed channel from t = 1000 s to 3000 s."""
    lx, ly, mu = 15.0e3, 1.5e3, 1.0e3
    nx = 8 * refinement
    mesh = T.RectangleMesh(nx, 2, lx, ly, device="cpu", dtype=F64)
    V = T.FunctionSpace(mesh, "DG", 1)
    asm = T.DGAssembler(mesh, V)
    t_init, t_end, x0 = 1000.0, 3000.0, lx / 2.0

    def exact(x, y, t):
        return -torch.special.erf((x - x0) / math.sqrt(4 * mu * t))

    eq = TTracer(mesh, asm, tracer_opts(), bathymetry=40.0,
                 labels=["tracer_2d"], bnd_conditions={})
    fields = {"diffusivity_h-tracer_2d": mu}
    c0 = T.Function(V).interpolate(lambda x, y: exact(x, y, t_init))
    dt = (lx / nx) ** 2 / mu / 250.0
    nsteps = int(round((t_end - t_init) / dt))
    final = march(TSSPRK33(eq, (t_end - t_init) / nsteps),
                  {"tracer_2d": c0.data}, fields, {}, nsteps)
    cex = T.Function(V).interpolate(lambda x, y: exact(x, y, t_end))
    return float(asm.norm_l2(final["tracer_2d"] - cex.data)) \
        / math.sqrt(lx * ly)


def check_slope(errors, refinements, expected, rtol=0.2):
    """``test_tracer_mes.py::check_slope``."""
    slope = stats.linregress(np.log(1.0 / np.asarray(refinements)),
                             np.log(errors)).slope
    assert slope > expected * (1 - rtol), f"slope {slope} < {expected}"
    return slope


def test_advection_mes():
    """``test_tracer_mes.py::test_advection_mes``: refinements 1 / 2 / 4,
    slope > 2 (1 - 0.2)."""
    refs = [1, 2, 4]
    errs = [port_advection(r) for r in refs]
    print("port advection slope:", check_slope(errs, refs, 2.0), errs)


def test_diffusion_mes():
    """``test_tracer_mes.py::test_diffusion_mes``: refinements 1 / 2 / 3,
    slope > 1.8 (1 - 0.2)."""
    refs = [1, 2, 3]
    errs = [port_diffusion(r) for r in refs]
    print("port diffusion slope:", check_slope(errs, refs, 1.8), errs)


@pytest.mark.parametrize("which", ["advection", "diffusion"])
def test_tracer_mes_coarsest_rung_matches_reference(which):
    """At refinement 1 the port's error is the reference's."""
    mes = reference_suite("test_tracer_mes")
    port = {"advection": port_advection, "diffusion": port_diffusion}[which]
    assert_parity(port(1), getattr(mes, f"run_{which}")(1))


# -- tests/test_swe_p2.py ---------------------------------------------------
def port_tracer_p2(nx, degree):
    """``test_swe_p2.py::run_tracer`` through the port: a sine carried
    at 1 m/s to t = 0.3 along a periodic channel (one strip of cells)."""
    lx, ly = 1.0, 1.0 / nx
    mesh = T.PeriodicRectangleMesh(nx, 1, lx, ly, direction="x",
                                   device="cpu", dtype=F64)
    V = T.FunctionSpace(mesh, "DG", degree)
    asm = T.DGAssembler(mesh, V)
    u0, t_end = 1.0, 0.3
    eq = TTracer(mesh, asm, tracer_opts(), bathymetry=1.0,
                 labels=["tracer_2d"], bnd_conditions={})
    uv = torch.tensor([u0, 0.0], dtype=F64).expand(mesh.nc, V.ndofs, 2)
    fields = {"uv_2d": uv, "elev_2d": 0.0,
              "lax_friedrichs_tracer_scaling_factor": 1.0}
    c0 = T.Function(V).interpolate(
        lambda x, y: torch.sin(2 * math.pi * x))
    nsteps = 6 * nx
    final = march(TSSPRK33(eq, t_end / nsteps), {"tracer_2d": c0.data},
                  fields, {}, nsteps)
    cex = T.Function(V).interpolate(
        lambda x, y: torch.sin(2 * math.pi * (x - u0 * t_end)))
    return float(asm.norm_l2(final["tracer_2d"] - cex.data)) \
        / math.sqrt(lx * ly)


def slopes2(errs):
    return [math.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]


@pytest.mark.parametrize("degree,min_slope", [(2, 2.5)])
def test_standing_wave_p2_order(degree, min_slope):
    """``test_swe_p2.py::test_standing_wave_p2_order``: 8 / 16 / 32, each
    successive slope > 2.5 (``chip_smoke.p2_standing_wave_error``, which
    phase 32 runs on the card)."""
    errs = [chip_smoke.p2_standing_wave_error(nx, degree, "cpu")
            for nx in (8, 16, 32)]
    print("port errs", errs, "slopes", slopes2(errs))
    assert min(slopes2(errs)) > min_slope


def test_p2_beats_p1():
    """``test_swe_p2.py::test_p2_beats_p1``: at 16, P2 < 0.2 P1."""
    e1 = chip_smoke.p2_standing_wave_error(16, 1, "cpu")
    e2 = chip_smoke.p2_standing_wave_error(16, 2, "cpu")
    assert e2 < 0.2 * e1, (e1, e2)


def test_tracer_p2_order():
    """``test_swe_p2.py::test_tracer_p2_order``: 8 / 16 / 32, each
    successive slope > 2.5."""
    errs = [port_tracer_p2(nx, 2) for nx in (8, 16, 32)]
    print("port tracer errs", errs, "slopes", slopes2(errs))
    assert min(slopes2(errs)) > 2.5


@pytest.mark.parametrize("which", ["standing_wave_p2", "standing_wave_p1",
                                   "tracer_p2"])
def test_p2_coarsest_rung_matches_reference(which):
    """At nx 8 the port's error is the reference's ``run`` /
    ``run_tracer``."""
    p2 = reference_suite("test_swe_p2")
    if which == "tracer_p2":
        assert_parity(port_tracer_p2(8, 2), p2.run_tracer(8, 2))
    else:
        degree = int(which[-1])
        assert_parity(chip_smoke.p2_standing_wave_error(8, degree, "cpu"),
                      p2.run(8, degree))
