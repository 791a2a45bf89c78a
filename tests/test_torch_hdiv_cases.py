"""The reference tests of the H(div) families (``tests/test_rtdg.py``,
``tests/test_rt2.py``) through ``thetis_tpu_torch`` on the CPU, f64, each
held to the reference test's own bound: the element exactness checks,
the standing waves through ``FlowSolver2d`` (RT1/BDM1 x P0 over a period,
RT2/BDM2 x P1DG over half of one) and the RT2 basin's volume.  The
convergence ladders (RT1 at two resolutions, RT2 against RT1, the RT2
order) and the 200-step forced channel run under ``-m slow``, as the
reference marks its ladders: 40-80 s each on the CPU.  Parity with the
reference is in ``test_torch_hdiv.py``."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_rt2 import (  # noqa: E402
    ShallowWaterEquationsRT2DG as TRT2DG)
from thetis_tpu_torch.equations.shallowwater_rtdg import (  # noqa: E402
    ShallowWaterEquationsRTDG as TRTDG)
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.bdm import BDMSpace as TBDM  # noqa: E402
from thetis_tpu_torch.fem.bdm2 import BDM2Space as TBDM2  # noqa: E402
from thetis_tpu_torch.fem.rt import RTSpace as TRT  # noqa: E402
from thetis_tpu_torch.fem.rt2 import RT2Space as TRT2  # noqa: E402
from thetis_tpu_torch.solvers.newton import NewtonParameters as TNP  # noqa: E402
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    CrankNicolson as TCN)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def tensor(v):
    return torch.as_tensor(np.array(v), dtype=F64)


def eq_options(nonlin=True):
    return SimpleNamespace(use_nonlinear_equations=nonlin,
                           use_wetting_and_drying=False)


def test_port_rt_exactness():
    """``test_rtdg.py::test_rt_exactness``."""
    mesh = T.RectangleMesh(6, 5, 3.0, 2.0, device="cpu")
    rt = TRT(mesh, TAsm(mesh, T.FunctionSpace(mesh, "DG", 1)))
    fv = mesh.facet_verts_np
    mids = 0.5 * (mesh.coords_np[fv[:, 0]] + mesh.coords_np[fv[:, 1]])
    U = tensor((mids * mesh.facet_normal_np).sum(1))  # u = (x, y)
    assert float((rt.cell_div(U) - 2.0).abs().max()) < 1e-12
    assert bool(torch.isfinite(rt.cell_values(U)).all())


def test_port_bdm_exactness():
    """``test_rtdg.py::test_bdm_exactness``."""
    mesh = T.RectangleMesh(5, 4, 2.0, 1.5, device="cpu")
    asm = TAsm(mesh, T.FunctionSpace(mesh, "DG", 1))
    bdm = TBDM(mesh, asm)
    nrm, fv, coords = mesh.facet_normal_np, mesh.facet_verts_np, \
        mesh.coords_np

    def proj(ufun):
        vals = ufun(coords)
        return tensor(np.stack([(vals[fv[:, 0]] * nrm).sum(-1),
                                (vals[fv[:, 1]] * nrm).sum(-1)], axis=-1))

    U = proj(lambda x: np.stack([x[:, 1], x[:, 0]], axis=-1))
    qp = asm.space._tab_np["qp"]
    cells = mesh.cells_np
    p0 = coords[cells[:, 0]]
    Jc = np.stack([coords[cells[:, 1]] - p0, coords[cells[:, 2]] - p0],
                  axis=2)
    xq = p0[:, None, :] + np.einsum("cij,qj->cqi", Jc, qp)
    exact = np.stack([xq[..., 1], xq[..., 0]], axis=-1)
    assert np.abs(bdm.cell_values(U).numpy() - exact).max() < 1e-12
    assert float(bdm.cell_div(U).abs().max()) < 1e-12
    U2 = proj(lambda x: x)
    assert float((bdm.cell_div(U2) - 2.0).abs().max()) < 1e-12
    Ui = bdm.mass_inverse(bdm.mass_apply(U2))
    assert float((Ui - U2).abs().max()) < 1e-8
    tr = bdm.facet_traces(U).numpy()
    un = (tr * nrm[:, None, None, :]).sum(-1)
    assert np.abs(un - bdm.facet_un_quad(U).numpy()[:, None, :]).max() \
        < 1e-12


def test_port_rt2_exactness():
    """``test_rt2.py::test_rt2_exactness``."""
    mesh = T.RectangleMesh(6, 5, 3.0, 2.0, device="cpu")
    rt = TRT2(mesh, TAsm(mesh, T.FunctionSpace(mesh, "DG", 1,
                                               quad_degree=5)))
    U = rt.project_vector(lambda x, y: np.stack(
        [0.3 + x - 2 * y, 1.0 + 0.5 * x + y], axis=-1))
    assert float((rt.cell_div_q(U) - 2.0).abs().max()) < 1e-10
    tr = rt.facet_traces(U).numpy()
    n = mesh.facet_normal_np[:, None, :]
    mi = ~mesh.facet_is_boundary_np
    assert np.abs(((tr[:, 0] - tr[:, 1]) * n).sum(-1)[mi]).max() < 1e-10


def test_port_bdm2_exactness():
    """``test_rt2.py::test_bdm2_exactness``."""
    mesh = T.RectangleMesh(7, 4, 3.0, 2.0, device="cpu")
    V = T.FunctionSpace(mesh, "DG", 1, quad_degree=5)
    bd = TBDM2(mesh, TAsm(mesh, V))
    U = bd.project_vector(lambda x, y: np.stack(
        [x * x - 0.5 * y * y + x, x * y + y], axis=-1))
    qp = V._tab_np["qp"]
    verts = mesh.coords_np[mesh.cells_np]
    lam = np.stack([1 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]], axis=1)
    xy = np.einsum("qd,cdi->cqi", lam, verts)
    exact = np.stack([xy[..., 0] ** 2 - 0.5 * xy[..., 1] ** 2 + xy[..., 0],
                      xy[..., 0] * xy[..., 1] + xy[..., 1]], axis=-1)
    assert np.abs(bd.cell_values(U).numpy() - exact).max() < 1e-10
    tr = bd.facet_traces(U).numpy()
    n = mesh.facet_normal_np[:, None, :]
    mi = ~mesh.facet_is_boundary_np
    assert np.abs(((tr[:, 0] - tr[:, 1]) * n).sum(-1)[mi]).max() < 1e-10
    U2 = bd.mass_inverse(bd.mass_apply(U))
    assert float((U2 - U).abs().max() / U.abs().max()) < 1e-10


def port_standing_wave_solver(family, p, nx, n_per_period, t_end_periods,
                              amp=0.01):
    """The standing wave of ``test_rtdg.py`` / ``test_rt2.py`` through
    the port's facade (5 x 1 km, depth 100 m)."""
    lx, ly, depth = 5e3, 1e3, 100.0
    c = math.sqrt(float(T.physical_constants["g_grav"]) * depth)
    period = 2 * lx / c
    mesh2d = T.RectangleMesh(nx, 2, lx, ly, device="cpu")
    so = T.solver2d.FlowSolver2d(mesh2d, T.Function(
        T.FunctionSpace(mesh2d, "CG", 1)).assign(depth))
    o = so.options
    o.element_family = family
    o.polynomial_degree = p
    o.timestep = period / n_per_period
    o.swe_timestepper_type = "CrankNicolson"
    o.no_exports = True
    so.create_function_spaces()
    if p == 0:
        mids = mesh2d.cell_midpoints()
        eta0 = tensor(amp * np.cos(np.pi * mids[:, 0] / lx)[:, None])
        o.simulation_export_time = period
        o.simulation_end_time = (t_end_periods * period
                                 - 0.1 * period / n_per_period)
        so.assign_initial_conditions(elev=eta0, uv=np.asarray([0.0, 0.0]))
    else:
        eta0 = T.Function(so.function_spaces.H_2d).interpolate(
            lambda x, y: amp * torch.cos(math.pi / lx * x))
        o.simulation_export_time = period / 4
        o.simulation_end_time = t_end_periods * period - 1e-3
        so.assign_initial_conditions(elev=eta0)
    return so, eta0


@pytest.mark.parametrize("family", ["rt-dg", "bdm-dg"])
def test_port_hdiv_p0_flowsolver(family):
    """``test_rtdg.py::test_rtdg_flowsolver`` and
    ``test_bdmdg_flowsolver_standing_wave``: 60x2, one period in 40 CN
    steps; volume to 1e-6, amplitude error under 0.05."""
    so, eta0 = port_standing_wave_solver(family, 0, 60, 40, 1.0)
    so.initialize()
    v0 = so.compute_volume_2d()
    so.iterate()
    v1 = so.compute_volume_2d()
    assert so.iteration == 40
    assert abs(v1 - v0) < 1e-6 * abs(v0)
    rel = float(so.eq_sw.norm_elev(so.fields.elev_2d.data - eta0)) \
        / math.sqrt(5e3 * 1e3) / 0.01
    assert rel < 0.05, rel


@pytest.mark.parametrize("family", ["rt-dg", "bdm-dg"])
def test_port_rt2_facade(family):
    """``test_rt2.py::test_rt2_facade``: half a period on 16x2, the
    wave's amplitude within 0.1."""
    so, eta0 = port_standing_wave_solver(family, 1, 16, 64, 0.5)
    so.iterate()
    e = so.fields.elev_2d.data
    err = float(so.asm.norm_l2(e + eta0.data)) / float(
        so.asm.norm_l2(eta0.data))
    assert err < 0.1, err
    assert bool(torch.isfinite(so.fields.uv_2d.data).all())


def port_cn(eq, dt, rtol):
    return TCN(eq, dt, semi_implicit=True, solver_parameters=TNP(
        ksp_rtol=rtol, ksp_max_it=400, gmres_restart=40))


def test_port_rt2_mass_conservation():
    """``test_rt2.py::test_rt2_mass_conservation``: 20 CN steps on a
    closed 10x4 basin conserve the volume to 1e-9."""
    mesh = T.RectangleMesh(10, 4, 2e3, 1e3, device="cpu")
    V = T.FunctionSpace(mesh, "DG", 1, quad_degree=5)
    asm = TAsm(mesh, V)
    rt = TRT2(mesh, asm)
    eq = TRT2DG(mesh, asm, rt, eq_options(), 50.0)
    eta0 = T.Function(V).interpolate(
        lambda x, y: 0.5 * torch.exp(-(((x - 1e3) / 300) ** 2))).data
    s = {"uv": rt.zero_dofs(), "elev": eta0}
    st = port_cn(eq, 5.0, 1e-12)
    for _ in range(20):
        s = st.advance(0.0, s, {}, {}, {})
    v0, v1 = float(asm.integrate(eta0)), float(asm.integrate(s["elev"]))
    assert abs(v1 - v0) < 1e-9 * max(1.0, abs(v0))
    assert bool(torch.isfinite(s["uv"]).all())


def rt_standing_wave(nx, degree_pair):
    """``test_rt2.py::run_standing_wave`` through the port: a tenth of a
    period in 4 nx linear CN steps; the L2 error against the analytic
    wave, over sqrt(area)."""
    lx, ly, depth, amp = 5e3, 1e3, 100.0, 0.01
    c = math.sqrt(float(T.physical_constants["g_grav"]) * depth)
    t_end = 2 * lx / c / 10.0
    nsteps = 4 * nx
    mesh = T.RectangleMesh(nx, 2, lx, ly, device="cpu")
    k = math.pi / lx
    omega = c * k
    if degree_pair == "rt2":
        V = T.FunctionSpace(mesh, "DG", 1, quad_degree=5)
        asm = TAsm(mesh, V)
        sp = TRT2(mesh, asm)
        eq = TRT2DG(mesh, asm, sp, eq_options(False), depth)
        eta0 = T.Function(V).interpolate(
            lambda x, y: amp * torch.cos(k * x)).data
        exact = T.Function(V).interpolate(
            lambda x, y: amp * torch.cos(k * x) * math.cos(omega * t_end))
        norm = asm.norm_l2
    else:
        asm = TAsm(mesh, T.FunctionSpace(mesh, "DG", 1))
        sp = TRT(mesh, asm)
        eq = TRTDG(mesh, asm, sp, eq_options(False), depth)
        mids = mesh.cell_midpoints()
        eta0 = tensor(amp * np.cos(k * mids[:, 0])[:, None])
        exact = T.Function(T.FunctionSpace(mesh, "DG", 0), data=eta0
                           * math.cos(omega * t_end))
        norm = eq.norm_elev
    s = {"uv": sp.zero_dofs(), "elev": eta0}
    st = port_cn(eq, t_end / nsteps, 1e-10)
    for _ in range(nsteps):
        s = st.advance(0.0, s, {}, {}, {})
    return float(norm(s["elev"] - exact.data)) / math.sqrt(lx * ly)


@pytest.mark.slow
def test_port_rt2_beats_rt1():
    """``test_rt2.py::test_rt2_beats_rt1``."""
    e1 = rt_standing_wave(16, "rt1")
    e2 = rt_standing_wave(16, "rt2")
    assert e2 < 0.35 * e1, (e1, e2)


@pytest.mark.slow
def test_port_rt2_standing_wave_order():
    """``test_rt2.py::test_rt2_standing_wave_order``."""
    errs = [rt_standing_wave(nx, "rt2") for nx in (8, 16, 32)]
    slopes = [math.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(slopes) > 1.5, (errs, slopes)


def rtdg_standing_wave(nx, timesteps):
    """``test_rtdg.py::run_standing_wave_rtdg`` through the port."""
    lx, ly, depth, amp = 5e3, 1e3, 100.0, 0.01
    period = 2 * lx / math.sqrt(float(T.physical_constants["g_grav"])
                                * depth)
    mesh = T.RectangleMesh(nx, 2, lx, ly, device="cpu")
    asm = TAsm(mesh, T.FunctionSpace(mesh, "DG", 1))
    rt = TRT(mesh, asm)
    eq = TRTDG(mesh, asm, rt, eq_options(), depth)
    mids = mesh.cell_midpoints()
    eta0 = tensor(amp * np.cos(np.pi * mids[:, 0] / lx)[:, None])
    s = {"uv": rt.zero_dofs(), "elev": eta0}
    st = port_cn(eq, period / timesteps, 1e-10)
    area = mesh.cell_area_np
    vol0 = float((area * s["elev"][:, 0].numpy()).sum())
    for _ in range(timesteps):
        s = st.advance(0.0, s, {}, {}, {})
    vol1 = float((area * s["elev"][:, 0].numpy()).sum())
    rel = float(eq.norm_elev(s["elev"] - eta0)) / math.sqrt(lx * ly) / amp
    return rel, abs(vol1 - vol0)


@pytest.mark.slow
def test_port_rtdg_standing_wave():
    """``test_rtdg.py::test_rtdg_standing_wave``: amplitude and volume at
    100x2 / 40 steps, first order against 50x2 / 20."""
    rel, dvol = rtdg_standing_wave(100, 40)
    assert dvol < 1e-6
    assert rel < 0.025, rel
    rel2, _ = rtdg_standing_wave(50, 20)
    assert rel < 0.65 * rel2, (rel, rel2)


@pytest.mark.slow
def test_port_rtdg_forced_channel():
    """``test_rtdg.py::test_rtdg_forced_channel``: 200 CN steps of a
    head-driven channel with quadratic drag reach the friction balance."""
    lx, ly, depth = 10e3, 2e3, 20.0
    mesh = T.RectangleMesh(25, 4, lx, ly, device="cpu")
    bnd = {1: {"elev": 0.5}, 2: {"elev": -0.5}}
    asm = TAsm(mesh, T.FunctionSpace(mesh, "DG", 1))
    rt = TRT(mesh, asm)
    eq = TRTDG(mesh, asm, rt, eq_options(), depth, bnd_conditions=bnd)
    fields = {"quadratic_drag_coefficient": tensor(2.5e-3)}
    st = TCN(eq, 100.0, semi_implicit=True, solver_parameters=TNP(
        ksp_rtol=1e-9, ksp_max_it=120, gmres_restart=30))
    s = {"uv": rt.zero_dofs(), "elev": torch.zeros(mesh.nc, 1,
                                                   dtype=F64)}
    for _ in range(200):
        s = st.advance(0.0, s, fields, fields, bnd)
    assert bool(torch.isfinite(s["uv"]).all())
    nrm = mesh.facet_normal_np
    U = s["uv"].numpy()
    sel = (np.abs(nrm[:, 0]) > 0.9) & ~mesh.facet_is_boundary_np
    u_sel = U[sel] * np.sign(nrm[sel, 0])
    assert u_sel.mean() > 0.1
    u_bal = math.sqrt(9.81 * 1.0 / lx * depth / 2.5e-3)
    assert abs(u_sel.mean() - u_bal) < 0.5 * u_bal, (u_sel.mean(), u_bal)
