"""The partitioned path of ``thetis_tpu_torch.parallel`` on the CPU (f64,
8 partitions, the reference's ``tests/test_parallel.py`` cases):

* the sharded tracer advection against the reference's
  ``sharded_tracer_advection`` on its 8 virtual devices (1e-12);
* the ``ShardedEquation`` SWE residual and mass operators equal, bit for
  bit, to the port's serial operators;
* SSPRK33 and the semi-implicit (matrix-free Newton) CN over the
  ``ShardedEquation`` against serial (1e-12, the reference's bound);
* ``ShardedAssembledCN`` with and without the coarse correction against
  the serial assembled CN (1e-10, the reference's bound; Krylov to 1e-13);
* ``_fgmres_flat`` with an ``allreduce`` over a split vector, giving the
  serial iterates;
* ``ShardedFlowSolver3d`` at 16x8x4 on 8 partitions against the port's
  serial step (1e-11, the reference's bound);
* the refusals (``dt_mode='split'``, per-facet BC values).

The port's serial operators and steps are held to the reference's serial
ones by the other ``test_torch_*`` files."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

from thetis_tpu_torch.equations.shallowwater_2d import (  # noqa: E402
    ShallowWaterEquations, swe_state)
from thetis_tpu_torch.fem.assembly import DGAssembler  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace  # noqa: E402
from thetis_tpu_torch.mesh.generation import RectangleMesh  # noqa: E402
from thetis_tpu_torch.model.flowsolver3d import FlowSolver  # noqa: E402
from thetis_tpu_torch.parallel.assembled_sharded import (  # noqa: E402
    ShardedAssembledCN)
from thetis_tpu_torch.parallel.shard import allreduce  # noqa: E402
from thetis_tpu_torch.parallel.sharded import ShardedEquation  # noqa: E402
from thetis_tpu_torch.parallel.sharded3d import (  # noqa: E402
    ShardedFlowSolver3d)
from thetis_tpu_torch.parallel.submesh import HaloPartition  # noqa: E402
from thetis_tpu_torch.solvers.assembled import (  # noqa: E402
    CoarseCorrection, PackedState, assemble_affine_operator, get_coloring)
from thetis_tpu_torch.solvers.newton import (  # noqa: E402
    NewtonParameters, _fgmres_flat)
from thetis_tpu_torch.timeintegration.steppers import (  # noqa: E402
    CrankNicolson, SSPRK33)

N_DEV = 8
CPU = ["cpu"] * N_DEV
F64 = torch.float64
LX, LY = 40e3, 10e3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tight():
    """The reference tests' Krylov parameters (test_parallel.py:242)."""
    return NewtonParameters(ksp_rtol=1e-13, ksp_max_it=400, gmres_restart=40)


def rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def t(x):
    return torch.tensor(x, dtype=F64)


@pytest.fixture(scope="module")
def swe_setup():
    """``test_parallel.py::swe_setup`` on the port: the 16x8 channel,
    every SWE term, an elevation and a flux boundary, 8 partitions."""
    mesh = RectangleMesh(16, 8, LX, LY, device="cpu")
    opts = SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)
    bathy_g = 20.0 + 5.0 * np.sin(mesh.coords_np[:, 0] / LX * np.pi)
    bnd = {1: {"elev": 0.3}, 2: {"flux": -1000.0}}
    V = FunctionSpace(mesh, "DG", 1)
    eq = ShallowWaterEquations(mesh, DGAssembler(mesh, V), opts,
                               bathymetry=torch.as_tensor(bathy_g),
                               bnd_conditions=bnd)
    part = HaloPartition(mesh, N_DEV, devices=CPU)

    def build_eq(sm, d):
        Vl = FunctionSpace(sm, "DG", 1)
        bl = torch.as_tensor(part.local_vertex_values(bathy_g)[d])
        return ShallowWaterEquations(sm, DGAssembler(sm, Vl), opts,
                                     bathymetry=bl, bnd_conditions=bnd)

    sharded = ShardedEquation(part, build_eq)
    rng = np.random.RandomState(0)
    sol = swe_state(torch.as_tensor(rng.randn(mesh.nc, 3, 2) * 0.1),
                    torch.as_tensor(rng.randn(mesh.nc, 3) * 0.1))
    fields = {"lax_friedrichs_velocity_scaling_factor": t(1.0),
              "quadratic_drag_coefficient": t(2.5e-3),
              "coriolis": t(1e-4), "viscosity_h": t(10.0)}
    bndv = {1: {"elev": t(0.3)}, 2: {"flux": t(-1000.0)}}
    sol_s = sharded.device_put({k: part.scatter_cells(v.numpy())
                                for k, v in sol.items()})
    return SimpleNamespace(mesh=mesh, eq=eq, part=part, sharded=sharded,
                           sol=sol, sol_s=sol_s, fields=fields, bndv=bndv)


def gathered(part, tree):
    return {k: part.gather_cells(v.detach().numpy()) for k, v in tree.items()}


def test_sharded_tracer_advection_matches_reference():
    """The port's partitioned tracer RHS against the reference's
    ``shard_map`` operator on its 8 virtual devices, on the same
    seeded fields (``test_parallel.py``'s 16x4 mesh)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from thetis_tpu.fem.functionspace import FunctionSpace as JFS
    from thetis_tpu.mesh.generation import RectangleMesh as JRect
    from thetis_tpu.parallel.partition import StripePartition as JStripe
    from thetis_tpu.parallel.shard import (
        make_device_mesh as j_device_mesh,
        sharded_tracer_advection as j_advection)
    from thetis_tpu_torch.parallel.partition import StripePartition
    from thetis_tpu_torch.parallel.shard import sharded_tracer_advection

    jm = JRect(16, 4, 8e3, 2e3)
    tm = RectangleMesh(16, 4, 8e3, 2e3, device="cpu")
    jp, tp = JStripe(jm, N_DEV), StripePartition(tm, N_DEV)
    rng = np.random.RandomState(1)
    c = rng.rand(tm.nc, 3)
    uv = 0.5 * rng.rand(tm.nc, 3, 2)

    dmesh = j_device_mesh(N_DEV)
    sh = NamedSharding(dmesh, P("cells"))
    r_ref = jp.gather_cells(np.asarray(j_advection(jp, JFS(jm, "DG", 1),
                                                   dmesh)(
        jax.device_put(jnp.asarray(jp.scatter_cells(c)), sh),
        jax.device_put(jnp.asarray(jp.scatter_cells(uv)), sh))))
    rhs = sharded_tracer_advection(tp, FunctionSpace(tm, "DG", 1), CPU)
    r = tp.gather_cells(rhs(torch.as_tensor(tp.scatter_cells(c)),
                            torch.as_tensor(tp.scatter_cells(uv))).numpy())
    assert np.abs(r - r_ref).max() <= 1e-12 * np.abs(r_ref).max()


def test_sharded_swe_residual_bit_exact(swe_setup):
    """The full SWE residual (every term, SIPG viscosity, LF, drag,
    Coriolis, the elevation and flux boundaries) through the halo path
    equals the serial one bit for bit; partitions that hold no facet of
    a marker drop its BC (the serial ``_build_masks``)."""
    s = swe_setup
    r_ser = s.eq.residual("all", s.sol, s.sol, s.fields, s.fields, s.bndv)
    r_sh = s.sharded.residual("all", s.sol_s, s.sol_s, s.fields, s.fields,
                              s.bndv)
    got = gathered(s.part, r_sh)
    for k in r_ser:
        assert np.array_equal(r_ser[k].numpy(), got[k]), k
    # some partitions hold no facet of marker 1 (x = 0) or 2 (x = LX)
    kept = [sorted(e.bnd_keys) for e in s.sharded.eqs]
    assert kept[0] == [1] and kept[-1] == [2] and kept[3] == []


def test_sharded_swe_residual_takes_vertex_fields(swe_setup):
    """A CG1 coefficient (a beta-plane Coriolis, as the bench's) reaches
    the partitions as a list of per-partition fields, each on its own
    vertices, and a per-cell field on its extended rows: the residual
    still equals the serial one bit for bit, as it does with the per-cell
    field striped in a dict."""
    s = swe_setup
    y = s.mesh.coords_np[:, 1]
    cells = np.random.RandomState(5).rand(s.mesh.nc, 3)
    fields = dict(s.fields, coriolis=1e-4 + 1e-9 * torch.as_tensor(y),
                  viscosity_h=torch.as_tensor(cells))
    cor_d = s.part.local_vertex_values(1e-4 + 1e-9 * y)
    cells_d = s.part.local_cell_values(cells)
    per_part = [dict(s.fields, coriolis=torch.as_tensor(cor_d[d]),
                     viscosity_h=torch.as_tensor(cells_d[d]))
                for d in range(N_DEV)]
    r_ser = s.eq.residual("all", s.sol, s.sol, fields, fields, s.bndv)
    got = gathered(s.part, s.sharded.residual(
        "all", s.sol_s, s.sol_s, per_part, per_part, s.bndv))
    for k in r_ser:
        assert np.array_equal(r_ser[k].numpy(), got[k]), k
    fields = dict(s.fields, viscosity_h=torch.as_tensor(cells))
    striped = dict(s.fields, viscosity_h=torch.as_tensor(
        s.part.scatter_cells(cells)))
    r_ser = s.eq.residual("all", s.sol, s.sol, fields, fields, s.bndv)
    got = gathered(s.part, s.sharded.residual(
        "all", s.sol_s, s.sol_s, striped, striped, s.bndv))
    for k in r_ser:
        assert np.array_equal(r_ser[k].numpy(), got[k]), k


def test_sharded_fields_refuse_what_is_not_striped(swe_setup):
    """A dict field that is not a striped cell tensor (a global vertex
    field) is refused, as is every non-scalar dict field of a mesh whose
    vertex and cell counts agree: neither can be read in stripe order."""
    s = swe_setup
    cor = torch.as_tensor(1e-4 + 1e-9 * s.mesh.coords_np[:, 1])
    with pytest.raises(ValueError, match="per-partition fields"):
        s.sharded.local_fields(dict(s.fields, coriolis=cor), 0)
    mesh = RectangleMesh(3, 2, 3e3, 2e3, device="cpu")   # nv 12, nc 12
    assert mesh.nv == mesh.nc
    part = HaloPartition(mesh, 2, devices=["cpu"] * 2)
    sh = ShardedEquation(part, lambda sm, d: None)
    with pytest.raises(ValueError, match="per-partition fields"):
        sh.local_fields({"viscosity_h": torch.zeros(mesh.nc, 3)}, 0)
    assert sh.local_fields({"coriolis": t(1e-4)}, 1)["coriolis"] == 1e-4


@pytest.mark.parametrize("op", ["mass_term", "mass_inverse"])
def test_sharded_swe_mass_ops_bit_exact(swe_setup, op):
    s = swe_setup
    a = getattr(s.eq, op)(s.sol)
    b = gathered(s.part, getattr(s.sharded, op)(s.sol_s))
    for k in a:
        assert np.array_equal(a[k].numpy(), b[k]), (op, k)


@pytest.mark.parametrize("stepper", ["SSPRK33", "CrankNicolson"])
def test_sharded_swe_steps_match_serial(swe_setup, stepper):
    """The unmodified serial steppers run partitioned through the
    ShardedEquation: explicit SSPRK33 and the semi-implicit CN (a global
    matrix-free Krylov over the striped state) match serial."""
    s = swe_setup
    make = {"SSPRK33": lambda e: SSPRK33(e, 5.0),
            "CrankNicolson": lambda e: CrankNicolson(e, 30.0,
                                                     semi_implicit=True)}
    ref = make[stepper](s.eq).advance(0.0, s.sol, s.fields, s.fields,
                                      s.bndv)
    out = gathered(s.part, make[stepper](s.sharded).advance(
        0.0, s.sol_s, s.fields, s.fields, s.bndv))
    for k in ref:
        assert rel_err(ref[k].detach().numpy(), out[k]) < 1e-12, k


def rest_coarse(s, dt):
    """``test_parallel.py::test_sharded_assembled_cn_with_coarse``'s
    coarse correction from the global rest-state blocks."""
    zero = swe_state(torch.zeros((s.mesh.nc, 3, 2), dtype=F64),
                     torch.zeros((s.mesh.nc, 3), dtype=F64))
    ps = PackedState(zero)

    def Fw(x):
        st0 = ps.unpack(x)
        r = s.eq.residual("all", st0, zero, s.fields, s.fields, s.bndv)
        m = s.eq.mass_term(st0)
        return ps.pack(swe_state(m["uv"] - 0.5 * dt * r["uv"],
                                 m["elev"] - 0.5 * dt * r["elev"]))

    blocks0, _ = assemble_affine_operator(Fw, ps.pack(zero), s.mesh)
    ring, _, _ = get_coloring(s.mesh)
    return CoarseCorrection(blocks0.detach(), np.asarray(ring), s.mesh,
                            target_size=16)


@pytest.mark.parametrize("coarse", [False, True])
def test_sharded_assembled_cn_matches_serial(swe_setup, coarse):
    """The partitioned assembled-Jacobian KSP (per-partition analytic
    blocks, halo-refreshed ring matvecs, allreduce dot products) against
    the serial assembled CN; with the coarse correction at the larger
    wave CFL (dt 120 s) where it matters."""
    s = swe_setup
    dt = 120.0 if coarse else 30.0
    cc = rest_coarse(s, dt) if coarse else None
    st_ser = CrankNicolson(s.eq, dt, semi_implicit=True,
                           assembled_solve=True, coarse=cc,
                           solver_parameters=tight())
    st_sh = ShardedAssembledCN(s.sharded, dt, solver_parameters=tight(),
                               coarse=cc)
    assert (st_sh.coarse is not None) == coarse
    ref = st_ser.advance(0.0, s.sol, s.fields, s.fields, s.bndv)
    out = gathered(s.part, st_sh.advance(0.0, s.sol_s, s.fields, s.fields,
                                         s.bndv))
    for k in ref:
        assert rel_err(ref[k].detach().numpy(), out[k]) < 1e-10, k
    assert st_sh.stats["ksp_rel_residual"] < 1e-12


def test_sharded_assembled_cn_fields_old_and_lag(swe_setup):
    """The general branch (``fields_old`` distinct from ``fields``, a
    Picard linearization state) against the serial assembled CN."""
    s = swe_setup
    fo = dict(s.fields, coriolis=t(2e-4))
    lag = {k: 1.1 * v for k, v in s.sol.items()}
    lag_s = {k: 1.1 * v for k, v in s.sol_s.items()}
    st_ser = CrankNicolson(s.eq, 30.0, semi_implicit=True,
                           assembled_solve=True, solver_parameters=tight())
    st_sh = ShardedAssembledCN(s.sharded, 30.0, solver_parameters=tight())
    ref = st_ser.advance(0.0, s.sol, s.fields, fo, s.bndv,
                         linearization_state=lag)
    out = gathered(s.part, st_sh.advance(0.0, s.sol_s, s.fields, fo,
                                         s.bndv, linearization_state=lag_s))
    for k in ref:
        assert rel_err(ref[k].detach().numpy(), out[k]) < 1e-10, k


@pytest.mark.parametrize("parts", [1, 4, 8])
def test_fgmres_allreduce_gives_the_serial_iterates(parts):
    """FGMRES on a vector split into ``parts`` rows, every reduction a
    sum of per-partition partials through ``allreduce``, walks the serial
    Krylov path: same cycles, same iterate to roundoff, also when the
    breakdown guard fires (an operator with fewer distinct eigenvalues
    than the restart)."""
    rng = np.random.RandomState(2)
    n = 96
    A = torch.as_tensor(rng.randn(n, n) * 0.1 + 3 * np.eye(n))
    Dg = torch.as_tensor(np.repeat([1.0, 2.0, 5.0], n // 3))
    b = torch.as_tensor(rng.randn(n))
    Minv = torch.as_tensor(1.0 / np.diag(A.numpy()))
    for op in (lambda v: A @ v, lambda v: Dg * v):
        st_ser, st_sh = {}, {}
        x, rn, bn = _fgmres_flat(op, b, lambda v: Minv * v, 1e-12, 8, 20,
                                 st_ser)
        xs, rns, bns = _fgmres_flat(
            lambda v: op(v.reshape(-1)).reshape(parts, -1),
            b.reshape(parts, -1),
            lambda v: (Minv * v.reshape(-1)).reshape(parts, -1),
            1e-12, 8, 20, st_sh, allreduce=allreduce)
        assert st_ser == st_sh
        assert abs(bns - bn) <= 1e-15 * bn
        assert (xs.reshape(-1) - x).abs().max() <= 1e-13 * x.abs().max()
        assert rns <= 1e-12 * bns


def test_fgmres_without_allreduce_is_unchanged():
    """``allreduce=None`` is the serial core: the iterate's bits do not
    depend on whether the hook is named."""
    rng = np.random.RandomState(3)
    A = torch.as_tensor(rng.randn(40, 40) * 0.2 + 2 * np.eye(40))
    b = torch.as_tensor(rng.randn(40))
    x1 = _fgmres_flat(lambda v: A @ v, b, lambda v: v, 1e-10, 6, 10)[0]
    x2 = _fgmres_flat(lambda v: A @ v, b, lambda v: v, 1e-10, 6, 10,
                      None, allreduce=None)[0]
    assert torch.equal(x1, x2)


def bad_bc(s):
    return {1: {"elev": torch.zeros(s.mesh.nf, dtype=F64)}}


def test_sharded_refuses_per_facet_bc_values(swe_setup):
    s = swe_setup
    with pytest.raises(ValueError, match="scalar or 0-d BC values"):
        s.sharded.residual("all", s.sol_s, s.sol_s, s.fields, s.fields,
                           bad_bc(s))


# -- the 3D step ------------------------------------------------------------
NZ = 4


def solver3d(m, b, **options):
    """``test_parallel.py::test_sharded_3d_step_matches_serial``'s
    solver: the barotropic Krylov to 1e-13 so both paths solve the same
    system to roundoff."""
    s = FlowSolver(m, torch.as_tensor(b), NZ)
    s.options.update(dict(
        timestep=30.0, simulation_export_time=300.0,
        simulation_end_time=300.0, use_turbulence=False,
        use_smagorinsky_viscosity=False, horizontal_viscosity=5.0,
        coriolis_frequency=1e-4, no_exports=True,
        barotropic_solver_parameters=NewtonParameters(
            ksp_rtol=1e-13, ksp_max_it=192, gmres_restart=48)))
    s.options.update(options)
    s.initialize()
    return s


@pytest.fixture(scope="module")
def setup3d():
    mesh = RectangleMesh(16, 8, LX, LY, device="cpu")
    bathy_g = 20.0 + 5.0 * np.sin(mesh.coords_np[:, 0] / LX * np.pi)
    ser = solver3d(mesh, bathy_g)
    x = mesh.coords_np[mesh.cells_np]
    elev0 = 0.3 * np.exp(-(((x[..., 0] - LX / 2) / 6e3) ** 2))
    salt0 = 30.0 + 2.0 * np.exp(-(((x[..., 0] - LX / 2) / 8e3) ** 2))
    ser.assign_initial_conditions(elev=torch.as_tensor(elev0),
                                  salt=torch.as_tensor(salt0))
    part = HaloPartition(mesh, N_DEV, devices=CPU)
    return SimpleNamespace(mesh=mesh, bathy=bathy_g, ser=ser, part=part)


@pytest.mark.parametrize("coriolis", ["f_plane", "beta_plane"])
def test_sharded_3d_step_matches_serial(setup3d, coriolis):
    """One partitioned mode-split 3D step (baroclinicity, the assembled
    barotropic solve over 8 partitions, ALE advection, vertical mixing on
    each partition's columns, coupling) against the serial step.  The
    f-plane step takes the serial solver's fields (scalars, as the
    reference's test passes them); with a CG1 Coriolis (the bench's beta
    plane) each partition's solver is built with its own vertices' values
    and the step takes each partition's own fields
    (``gather_swe_fields``)."""
    s = setup3d
    state = s.ser._get_state()
    swe_fields = s.ser._gather_swe_fields()
    opts, fields_sh = {}, swe_fields
    if coriolis == "beta_plane":
        cor = 1e-4 + 1e-10 * s.mesh.coords_np[:, 1]
        swe_fields["coriolis"] = torch.as_tensor(cor)
        opts = [dict(coriolis_frequency=torch.as_tensor(c))
                for c in s.part.local_vertex_values(cor)]
    out_ser = s.ser._step(state, swe_fields, {})
    sh3 = ShardedFlowSolver3d(s.part, lambda sm, d: solver3d(
        sm, s.part.local_vertex_values(s.bathy)[d],
        **(opts[d] if opts else {})))
    assert isinstance(sh3.swe_stepper, ShardedAssembledCN)
    if coriolis == "beta_plane":
        fields_sh = sh3.gather_swe_fields()
    out_sh = gathered(s.part, sh3.step(
        sh3.device_put({k: s.part.scatter_cells(v.numpy())
                        for k, v in state.items()}), fields_sh, {}))
    assert sorted(out_sh) == sorted(out_ser)
    for k in out_ser:
        assert rel_err(out_ser[k].numpy(), out_sh[k]) < 1e-11, k


def test_sharded_3d_refuses_split_mode(setup3d):
    s = setup3d
    with pytest.raises(NotImplementedError, match="dt_mode='split'"):
        ShardedFlowSolver3d(s.part, lambda sm, d: solver3d(
            sm, s.part.local_vertex_values(s.bathy)[d], dt_mode="split",
            use_automatic_timestep=True))
