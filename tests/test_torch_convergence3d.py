"""The reference's 3D convergence suites through ``thetis_tpu_torch``, on
the CPU in f64, each under the reference test's own ladder and bound:

* ``tests/test_barotropic_mes3d.py``: the barotropic standing wave over
  one cycle, SSPRK22 mode split (the 2D CN is the port's assembled
  solve), refinements 1 / 2 / 4, elevation slope > 1.76 and the final
  velocity under 0.35 A sqrt(g/H); the run is
  ``chip_smoke.barotropic_mes_error``, which phase 32 runs on the card;
* ``tests/test_int_pg_mes.py``: the baroclinic head exact to roundoff and
  the internal pressure gradient's order over a sloping bed, with the P1
  head (slope > 0.8, finest relative error < 0.15) and the quadratic one
  (slope > 1.6, each rung under 0.35 of P1's);
* ``tests/test_momentum3d.py::test_hviscosity_mes``: the SIPG horizontal
  viscosity's decay of a sine on 8 / 16 / 32, forward Euler on
  ``MomentumEquation3D``, slope > 1.7.

Each suite has a parity case at its coarsest rung: the port's error
norms equal the reference's to rtol 1e-9 (f64; the head's error, which
is roundoff in both, is held to its bound instead).  The barotropic
parity case is ``slow``: the reference's run compiles for ~35 s on a
cold cache (the port's ~2 s), and so is the viscosity ladder (~60 s of
eager steps); everything else here takes seconds."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from test_torch_convergence2d import (  # noqa: E402
    assert_parity, reference_suite)
from thetis_tpu import DGAssembler as JAsm  # noqa: E402
from thetis_tpu import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D as JMom)
from thetis_tpu.fem.assembly3d import Assembler3D as JA3  # noqa: E402
from thetis_tpu.mesh.extruded import ExtrudedMesh as JExt  # noqa: E402
from thetis_tpu.mesh.generation import (  # noqa: E402
    PeriodicRectangleMesh as JPeriodic)
from thetis_tpu_torch.equations.momentum_3d import (  # noqa: E402
    MomentumEquation3D as TMom)
from thetis_tpu_torch.equations.utility3d import (  # noqa: E402
    BaroclinicHeadCalculator as TBHC)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.assembly3d import Assembler3D as TA3  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh as TExt  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


# -- tests/test_barotropic_mes3d.py -----------------------------------------
@pytest.mark.parametrize("timestepper_type", ["SSPRK22"])
def test_barotropic_standing_wave_mes(timestepper_type):
    """``test_barotropic_mes3d.py::test_barotropic_standing_wave_mes``:
    slope of log10(elevation error) on log10(1/r) > 2 (1 - 0.12), and the
    finest run's velocity < 0.35 u_scale."""
    refs = [1, 2, 4]
    errs = [chip_smoke.barotropic_mes_error(r, "cpu", timestepper_type)[0]
            for r in refs]
    slope = stats.linregress(np.log10(1.0 / np.asarray(refs, dtype=float)),
                             np.log10([e[0] for e in errs])).slope
    print("port barotropic errors", errs, "slope", slope)
    assert slope > 2.0 * (1 - 0.12), (slope, errs)
    u_scale = 0.01 * np.sqrt(9.81 / 100.0)
    assert errs[-1][1] < 0.35 * u_scale


@pytest.mark.slow
def test_barotropic_coarsest_rung_matches_reference():
    """At refinement 1 the port's elevation error and velocity norm are
    the reference's ``run(1)``."""
    mes = reference_suite("test_barotropic_mes3d")
    assert_parity(chip_smoke.barotropic_mes_error(1, "cpu")[0], mes.run(1))


# -- tests/test_int_pg_mes.py -----------------------------------------------
def port_int_pg(refinement, quadratic=False):
    """``test_int_pg_mes.py::run`` through the port: (head error,
    int_pg error, int_pg scale) of the analytic density a sin(kx) z on
    an 8 r x 2 channel of 4 r layers over a bed sloping 20 -> 40 m."""
    mes = reference_suite("test_int_pg_mes")
    nx, nz = 8 * refinement, 4 * refinement
    mesh = tgen.RectangleMesh(nx, 2, mes.LX, mes.LY, device="cpu",
                              dtype=F64)
    asm = TAsm(mesh, TFS(mesh, "DG", 1))
    ext = TExt(mesh, nz)
    a3 = TA3(mesh, asm, ext)
    bathy = 20.0 + 20.0 * mesh.coords_np[:, 0] / mes.LX
    bathy_cell = torch.tensor(bathy[mesh.cells_np], dtype=F64)
    z_if = ext.z_interfaces(bathy_cell, torch.zeros(mesh.nc, 3, dtype=F64))
    geom = a3.layer_geometry(z_if)
    x_dof = mesh.coords_np[mesh.cells_np][..., 0]
    z_np = z_if.numpy()
    z_nodes = np.stack([z_np[:, :, :-1], z_np[:, :, 1:]], axis=-1)
    bhc = TBHC(a3)
    if quadratic:
        x6 = bhc._to_p2_nodes(torch.tensor(x_dof, dtype=F64)).numpy()
        z6 = bhc._to_p2_nodes(z_if).numpy()
        zb, zt = z6[:, :, :-1], z6[:, :, 1:]
        z3 = np.stack([zb, 0.5 * (zb + zt), zt], axis=-1)
        rho = torch.tensor(mes.rho_fn(x6[:, :, None, None], z3))
    else:
        rho = torch.tensor(mes.rho_fn(x_dof[:, :, None, None], z_nodes))
    r = bhc.compute_head(rho, geom, quadratic=quadratic)
    int_pg = bhc.compute_int_pg(r, geom)
    if quadratic:
        r = r[:, :3, :, ::2]
    r_exact = mes.head_fn(x_dof[:, :, None, None], z_nodes)
    pg_exact = mes.intpg_x_fn(x_dof[:, :, None, None], z_nodes)
    w = geom["Delta_nodes"].numpy()[..., None]
    vol = float(w.sum() * 2)
    err_r = math.sqrt(float((w * (r.numpy() - r_exact) ** 2).sum()) / vol)
    err_pg = math.sqrt(float(
        (w * (int_pg[..., 0].numpy() - pg_exact) ** 2).sum()) / vol)
    scale = math.sqrt(float((w * pg_exact ** 2).sum()) / vol)
    return err_r, err_pg, scale


def x_log(refs):
    return np.log10(1.0 / np.asarray(refs, dtype=float))


def test_int_pg_mes():
    """``test_int_pg_mes.py::test_int_pg_mes``: the head to 1e-12 of its
    scale, int_pg slope > 0.8, the finest relative error < 0.15."""
    refs = [1, 2, 4]
    out = [port_int_pg(r) for r in refs]
    sl_pg = stats.linregress(x_log(refs), np.log10([o[1] for o in out])).slope
    print("port int_pg", out, "slope", sl_pg)
    for err_r, _, scale in out:
        assert err_r < 1e-12 * max(scale, 1.0), err_r
    assert sl_pg > 1.0 * (1 - 0.2), sl_pg
    assert out[-1][1] / out[-1][2] < 0.15


def test_int_pg_quadratic_pressure():
    """``test_int_pg_mes.py::test_int_pg_quadratic_pressure``: the
    quadratic head exact, slope > 1.6, each rung under 0.35 of P1's."""
    refs = [1, 2, 4]
    out_p1 = [port_int_pg(r) for r in refs]
    out_p2 = [port_int_pg(r, quadratic=True) for r in refs]
    sl_p2 = stats.linregress(x_log(refs),
                             np.log10([o[1] for o in out_p2])).slope
    print("port quadratic int_pg", out_p2, "slope", sl_p2)
    for err_r, _, scale in out_p2:
        assert err_r < 1e-12 * max(scale, 1.0), err_r
    assert sl_p2 > 2.0 * (1 - 0.2), sl_p2
    for p1, p2 in zip(out_p1, out_p2):
        assert p2[1] < 0.35 * p1[1], (p1[1], p2[1])


@pytest.mark.parametrize("quadratic", [False, True], ids=["p1", "quadratic"])
def test_int_pg_coarsest_rung_matches_reference(quadratic):
    """At refinement 1 the int_pg error and scale are the reference's;
    the head's error is roundoff in both, each under its bound."""
    mes = reference_suite("test_int_pg_mes")
    port = port_int_pg(1, quadratic)
    ref = mes.run(1, quadratic=quadratic)
    assert_parity(port[1:], ref[1:])
    for err_r, _, scale in (port, ref):
        assert err_r < 1e-12 * max(scale, 1.0)


# -- tests/test_momentum3d.py::test_hviscosity_mes --------------------------
HV_NU, HV_LX = 50.0, 16e3
HV_K = 2 * np.pi / HV_LX
HV_T = 0.25 / (HV_NU * HV_K ** 2)


def hv_steps(nx):
    """The reference test's forward-Euler steps and their dt at nx."""
    h = HV_LX / nx
    n_steps = int(np.ceil(HV_T / (0.0015 * h ** 2 / HV_NU)))
    return n_steps, HV_T / n_steps


def port_hviscosity_error(nx):
    """One rung of ``test_hviscosity_mes`` through the port: the relative
    L2 error of sin(kx) decayed by the SIPG viscosity against
    exp(-nu k^2 T) sin(kx)."""
    mesh = tgen.PeriodicRectangleMesh(nx, 2, HV_LX, 2e3, direction="x",
                                      device="cpu", dtype=F64)
    V = TFS(mesh, "DG", 1)
    ext = TExt(mesh, 2)
    a3 = TA3(mesh, TAsm(mesh, V), ext)
    bathy = torch.full((mesh.nc, 3), 20.0, dtype=F64)
    geom = a3.layer_geometry(ext.z_interfaces(bathy, torch.zeros_like(bathy)))
    eq = TMom(mesh, a3, SimpleNamespace(use_nonlinear_equations=False,
                                        use_lax_friedrichs_velocity=False,
                                        sipg_factor=1.0))
    x3 = V.dof_coords()[..., 0][:, :, None, None].expand(
        mesh.nc, 3, ext.nz, 2)
    u = torch.zeros(mesh.nc, 3, ext.nz, 2, 2, dtype=F64)
    u[..., 0] = torch.sin(HV_K * x3)
    fields = {"viscosity_h": torch.tensor(HV_NU, dtype=F64)}
    n_steps, dt = hv_steps(nx)
    for _ in range(n_steps):
        r = eq.residual("explicit", {"uv_3d": u}, {"uv_3d": u}, fields,
                        fields, {}, geom=geom)
        u = u + dt * eq.mass_inverse(r, geom)["uv_3d"]
    exact = torch.sin(HV_K * x3) * math.exp(-HV_NU * HV_K ** 2 * HV_T)
    e = u[..., 0] - exact
    return float(torch.sqrt((e * a3.mass_apply(e, geom)).sum())
                 / torch.sqrt((exact * a3.mass_apply(exact, geom)).sum()))


def reference_hviscosity_error(nx):
    """The same rung through ``thetis_tpu``: the reference test's loop
    body for one nx (its ``lax.scan`` of forward-Euler steps)."""
    mesh = JPeriodic(nx, 2, HV_LX, 2e3, direction="x")
    V = JFS(mesh, "DG", 1)
    ext = JExt(mesh, n_layers=2)
    a3 = JA3(mesh, JAsm(mesh, V), ext)
    bathy = jnp.full((mesh.nc, 3), 20.0)
    geom = a3.layer_geometry(ext.z_interfaces(bathy,
                                              jnp.zeros((mesh.nc, 3))))
    eq = JMom(mesh, a3, SimpleNamespace(use_nonlinear_equations=False,
                                        use_lax_friedrichs_velocity=False,
                                        sipg_factor=1.0))
    x3 = jnp.broadcast_to(V.dof_coords()[..., 0][:, :, None, None],
                          (mesh.nc, 3, ext.nz, 2))
    uv0 = jnp.zeros((mesh.nc, 3, ext.nz, 2, 2)).at[..., 0].set(
        jnp.sin(HV_K * x3))
    fields = {"viscosity_h": jnp.asarray(HV_NU)}
    n_steps, dt = hv_steps(nx)

    def fe_step(u, _):
        r = eq.residual("explicit", {"uv_3d": u}, {"uv_3d": u}, fields,
                        fields, {}, geom=geom)
        return u + dt * eq.mass_inverse(r, geom)["uv_3d"], None

    u_t = jax.lax.scan(fe_step, uv0, None, length=n_steps)[0]
    exact = jnp.sin(HV_K * x3) * np.exp(-HV_NU * HV_K ** 2 * HV_T)
    e = u_t[..., 0] - exact
    return float(jnp.sqrt((e * a3.mass_apply(e, geom)).sum())
                 / jnp.sqrt((exact * a3.mass_apply(exact, geom)).sum()))


@pytest.mark.slow
def test_hviscosity_mes():
    """``test_momentum3d.py::test_hviscosity_mes``: 8 / 16 / 32, slope of
    log(error) on log(h) > 1.7 (``slow``: 5,674 eager forward-Euler
    steps, ~60 s on the CPU)."""
    ns = (8, 16, 32)
    errs = [port_hviscosity_error(nx) for nx in ns]
    slope = stats.linregress(np.log([HV_LX / nx for nx in ns]),
                             np.log(errs)).slope
    print("port hviscosity errors", errs, "slope", slope)
    assert slope > 1.7, (slope, errs)


def test_hviscosity_coarsest_rung_matches_reference():
    """At nx 8 the port's relative error is the reference's."""
    assert_parity(port_hviscosity_error(8), reference_hviscosity_error(8))
