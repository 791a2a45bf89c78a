"""The quadratic baroclinic head and density and the remaining 3D
diagnostics (ROADMAP A7e), ``thetis_tpu_torch`` against ``thetis_tpu``
(f64, CPU), from the same numpy inputs, on an open 8x4 rectangle x 3
layers with a bed sloping in both directions and a wavy free surface:

* the P2 tabulations of ``Assembler3D`` and ``cell_grads`` on the
  quadratic vertical and horizontal bases;
* ``DensitySolver.solve_p2`` in its vertical and its horizontal (P2DG x
  P2) form, under the linear and the Jackett EOS;
* the quadratic head from P1 and from P2 densities, and
  ``compute_int_pg`` on it;
* ``DensitySolverWeak``, ``VelocityMagnitudeSolver`` and
  ``Mesh3DConsistencyCalculator``;
* two steps of the model with ``use_quadratic_pressure`` and
  ``use_quadratic_density`` (Jackett EOS, both tracers).

Tolerances: 1e-11 of max|ref| for the operators (the same algebra summed
in other orders; the tabulations exactly); 1e-8 of each field's scale
after two steps, as ``tests/test_torch_3d_slice.py``."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.equations import eos as jeos  # noqa: E402
from thetis_tpu.equations import utility3d as ju3  # noqa: E402
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.assembly3d import Assembler3D as JA3  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.mesh.extruded import ExtrudedMesh as JExt  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu_torch.equations import eos as teos  # noqa: E402
from thetis_tpu_torch.equations import utility3d as tu3  # noqa: E402
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.assembly3d import Assembler3D as TA3  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    FunctionSpace as TFS)
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_keys, state3d_to_numpy)
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh as TExt  # noqa: E402

F64 = torch.float64
NX, NY, NZ = 8, 4, 3
LX, LY = 40e3, 20e3
RTOL = 1e-11
STEP_RTOL = 1e-8
EOS = {"linear": (jeos.LinearEquationOfState, teos.LinearEquationOfState),
       "jackett": (jeos.JackettEquationOfState,
                   teos.JackettEquationOfState)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    def __init__(self):
        jm = jgen.RectangleMesh(NX, NY, LX, LY)
        tm = tgen.RectangleMesh(NX, NY, LX, LY, device="cpu", dtype=F64)
        self.jm, self.tm, self.nc = jm, tm, jm.nc
        self.ja = JA3(jm, JAsm(jm, JFS(jm, "DG", 1)), JExt(jm, NZ))
        self.ta = TA3(tm, TAsm(tm, TFS(tm, "DG", 1)), TExt(tm, NZ))
        xy = jm.coords_np
        self.bathy = (20.0 - 10.0 * xy[:, 0] / LX
                      + 4.0 * xy[:, 1] / LY)[jm.cells_np]
        self.elev = (0.3 * np.cos(np.pi * xy[:, 0] / LX)
                     * (0.5 + xy[:, 1] / LY))[jm.cells_np]
        self.jz = self.ja.ext.z_interfaces(jnp.asarray(self.bathy),
                                           jnp.asarray(self.elev))
        self.tz = self.ta.ext.z_interfaces(torch.tensor(self.bathy),
                                           torch.tensor(self.elev))
        self.jg = self.ja.layer_geometry(self.jz)
        self.tg = self.ta.layer_geometry(self.tz)
        rng = np.random.default_rng(5)
        self.salt = 30.0 + 4.0 * rng.random((self.nc, 3, NZ, 2))
        self.temp = 5.0 + 15.0 * rng.random((self.nc, 3, NZ, 2))
        self.uv = 0.3 * rng.standard_normal((self.nc, 3, NZ, 2, 2))
        self.w = 1e-3 * rng.standard_normal((self.nc, 3, NZ, 2))


@pytest.fixture(scope="module")
def case():
    return Case()


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def test_p2_tabulations(case):
    for name in ("_psi2_h", "_dpsi2_h", "_phi2d_h", "_dphi2d_h"):
        np.testing.assert_array_equal(getattr(case.ta, name),
                                      getattr(case.ja, name))
    # the Lagrange property at the quadrature points: rows sum to one,
    # gradient rows to zero
    np.testing.assert_allclose(case.ta._phi2d_h.sum(1), 1.0, atol=1e-15)
    np.testing.assert_allclose(case.ta._dphi2d_h.sum(1), 0.0, atol=1e-14)
    np.testing.assert_allclose(case.ta._psi2_h.sum(1), 1.0, atol=1e-15)


@pytest.mark.parametrize("basis", ["p2_vertical", "p2_horizontal", "p2_both"])
def test_cell_grads_on_quadratic_bases(case, basis):
    rng = np.random.default_rng(9)
    nh = 6 if basis != "p2_vertical" else 3
    npp = 3 if basis != "p2_horizontal" else 2
    u = rng.standard_normal((case.nc, nh, NZ, npp))
    jv = (case.ja._psi2_h, case.ja._dpsi2_h) if npp == 3 else None
    jh = (case.ja._phi2d_h, case.ja._dphi2d_h) if nh == 6 else None
    tv = case.ta.p2_vtabs if npp == 3 else None
    th = case.ta.p2_htabs if nh == 6 else None
    close(case.ta.cell_grads(torch.tensor(u), case.tg, vtabs=tv, htabs=th),
          case.ja.cell_grads(jnp.asarray(u), case.jg, vtabs=jv, htabs=jh))


@pytest.mark.parametrize("horizontal", [False, True])
@pytest.mark.parametrize("eos", sorted(EOS))
def test_density_solve_p2(case, eos, horizontal):
    je, te = EOS[eos]
    jd, td = ju3.DensitySolver(je()), tu3.DensitySolver(te())
    want = jd.solve_p2(jnp.asarray(case.salt), jnp.asarray(case.temp),
                       horizontal=horizontal)
    got = td.solve_p2(torch.tensor(case.salt), torch.tensor(case.temp),
                      horizontal=horizontal)
    close(got, want)
    assert tuple(got.shape) == (case.nc, 6 if horizontal else 3, NZ, 3)
    # a layered pressure takes the same path
    p = np.broadcast_to(-case.tz.numpy()[..., :-1, None],
                        (case.nc, 3, NZ, 2)).copy()
    close(td.solve_p2(torch.tensor(case.salt), torch.tensor(case.temp),
                      torch.tensor(p), horizontal=horizontal),
          jd.solve_p2(jnp.asarray(case.salt), jnp.asarray(case.temp),
                      jnp.asarray(p), horizontal=horizontal))


@pytest.mark.parametrize("rho", ["p1", "p2_vertical", "p2_horizontal"])
def test_quadratic_head_and_int_pg(case, rho):
    """The quadratic head on the sloped bed from a P1 density, a vertical
    P2 density and the P2DG x P2 one, and its internal pressure
    gradient."""
    jd = ju3.DensitySolver(jeos.JackettEquationOfState())
    td = tu3.DensitySolver(teos.JackettEquationOfState())
    js, jt = jnp.asarray(case.salt), jnp.asarray(case.temp)
    ts, tt = torch.tensor(case.salt), torch.tensor(case.temp)
    if rho == "p1":
        jr, tr = jd.solve(js, jt), td.solve(ts, tt)
    else:
        h = rho == "p2_horizontal"
        jr = jd.solve_p2(js, jt, horizontal=h)
        tr = td.solve_p2(ts, tt, horizontal=h)
    jb = ju3.BaroclinicHeadCalculator(case.ja)
    tb = tu3.BaroclinicHeadCalculator(case.ta)
    jh = jb.compute_head(jr, case.jg, quadratic=True)
    th = tb.compute_head(tr, case.tg, quadratic=True)
    close(th, jh)
    assert tuple(th.shape) == (case.nc, 6, NZ, 3)
    close(tb.compute_int_pg(th, case.tg), jb.compute_int_pg(jh, case.jg))
    if rho != "p2_horizontal":  # the P1 head from the same density
        close(tb.compute_head(tr, case.tg), jb.compute_head(jr, case.jg))


def test_quadratic_head_of_a_linear_density_is_exact(case):
    """For a density linear in z the P2 head is the exact integral: at the
    layer midpoint it is the mean of the two ends plus the quadratic's
    correction, which the P1 head cannot hold."""
    tb = tu3.BaroclinicHeadCalculator(case.ta)
    z = case.tz
    zn = torch.stack([z[..., :-1], z[..., 1:]], dim=-1)   # (nc, 3, nz, 2)
    rho = 0.5 * zn                                          # d rho/dz = 0.5
    head = tb.compute_head(rho, case.tg, quadratic=True)
    eta = z[..., -1:, None]                                 # (nc, 3, 1, 1)
    zm = 0.5 * (zn[..., 0] + zn[..., 1])
    zq = torch.stack([zn[..., 0], zm, zn[..., 1]], dim=-1)[:, :3]
    exact = -1.0 / tb.rho0 * 0.25 * (eta**2 - zq**2)
    close(head[:, :3], exact.numpy(), rtol=1e-12)


@pytest.mark.parametrize("eos", sorted(EOS))
def test_density_solver_weak(case, eos):
    je, te = EOS[eos]
    jw = ju3.DensitySolverWeak(case.ja, je())
    tw = tu3.DensitySolverWeak(case.ta, te())
    close(tw.solve(torch.tensor(case.salt), torch.tensor(case.temp),
                   case.tg),
          jw.solve(jnp.asarray(case.salt), jnp.asarray(case.temp), case.jg))


@pytest.mark.parametrize("which", ["uv", "w", "both"])
def test_velocity_magnitude_solver(case, which):
    jv = ju3.VelocityMagnitudeSolver(case.ja, min_val=1e-3)
    tv = tu3.VelocityMagnitudeSolver(case.ta, min_val=1e-3)
    uv = case.uv if which != "w" else None
    w = case.w if which != "uv" else None
    got = tv.solve(case.tg, uv=None if uv is None else torch.tensor(uv),
                   w=None if w is None else torch.tensor(w))
    want = jv.solve(case.jg, uv=None if uv is None else jnp.asarray(uv),
                    w=None if w is None else jnp.asarray(w))
    close(got, want)
    assert float(got.min()) >= 1e-3


def test_mesh_consistency_calculator(case):
    close(tu3.Mesh3DConsistencyCalculator.compute(case.tz),
          ju3.Mesh3DConsistencyCalculator.compute(case.jz))
    jm, tm = case.jm, case.tm
    js = JFlow(jm, jnp.asarray(case.bathy), NZ)
    js.create_fields()
    js.fields.elev_2d.data = jnp.asarray(case.elev)
    ts = flowsolver3d_from_numpy(tm, case.bathy, NZ, {})
    ts.create_fields()
    ts.fields.elev_2d.data = torch.tensor(case.elev)
    got = tu3.Mesh3DConsistencyCalculator(ts).solve()
    close(got, ju3.Mesh3DConsistencyCalculator(js).solve())
    assert float(got.max()) > 0.0


@pytest.fixture(scope="module")
def quad_run():
    jm = jgen.RectangleMesh(NX, NY, LX, LY)
    tm = tgen.RectangleMesh(NX, NY, LX, LY, device="cpu", dtype=F64)
    xy = jm.coords_np
    bathy = 20.0 - 10.0 * xy[:, 0] / LX + 4.0 * xy[:, 1] / LY
    opts = dict(timestepper_type="SSPRK22", solve_salinity=True,
                solve_temperature=True, equation_of_state_type="full",
                use_quadratic_pressure=True, use_quadratic_density=True,
                coriolis_frequency=1.15e-4, timestep=60.0,
                horizontal_viscosity=5.0, horizontal_diffusivity=10.0,
                simulation_export_time=120.0, simulation_end_time=120.0,
                no_exports=True)
    rng = np.random.default_rng(2)
    xc = xy[jm.cells_np]
    salt = np.broadcast_to((30 + 4 * xc[..., 0] / LX)[:, :, None, None],
                           (jm.nc, 3, NZ, 2)).copy()
    sig = np.array([[0.0, 1.0], [1.0, 2.0], [2.0, 3.0]]) / NZ
    temp = 20.0 - 8.0 * (1 - sig) + 0.5 * rng.random((jm.nc, 3, NZ, 2))
    js = JFlow(jm, jnp.asarray(bathy), NZ)
    js.options.update(opts)
    js.assign_initial_conditions(elev=jnp.zeros((jm.nc, 3)),
                                 salt=jnp.asarray(salt),
                                 temp=jnp.asarray(temp))
    j_out = js._advance_n_jit(js._get_state(), js._gather_swe_fields(), {},
                              n=2)
    ts = flowsolver3d_from_numpy(tm, bathy, NZ, opts)
    ts.assign_initial_conditions(elev=np.zeros((tm.nc, 3)), salt=salt,
                                 temp=temp)
    state = ts._get_state()
    f = ts._gather_swe_fields()
    out = ts._step(ts._step(state, f, {}), f, {})
    # the same steps on the P1 head and density
    p1 = flowsolver3d_from_numpy(tm, bathy, NZ, dict(
        opts, use_quadratic_pressure=False, use_quadratic_density=False))
    p1.initialize()
    p1_out = p1._step(p1._step(state, f, {}), f, {})
    return dict(ts=ts, state=state, want={k: np.asarray(v)
                                          for k, v in j_out.items()},
                got=state3d_to_numpy(out), p1=state3d_to_numpy(p1_out))


@pytest.mark.parametrize("key", state3d_keys())
def test_two_quadratic_steps_match_reference(quad_run, key):
    want, got = quad_run["want"][key], quad_run["got"][key]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=STEP_RTOL,
        atol=STEP_RTOL * max(np.abs(want).max(), 1e-300))


def test_quadratic_head_changes_the_step(quad_run):
    """Not the P1 step under another name: the velocity differs from the
    same two steps on the P1 head and density."""
    diff = np.abs(quad_run["got"]["uv_3d"] - quad_run["p1"]["uv_3d"]).max()
    assert diff > 1e-6 * np.abs(quad_run["got"]["uv_3d"]).max()
