"""Sphere meshes and the gmsh reader of ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): ``mesh/sphere.py`` (the refined icosahedron,
the outward orientation, the tangent-plane geometry), the RT1/BDM1
spaces and the rt-dg equations on it (the cell-normal Coriolis of a
vertex-valued f), Williamson 2 through ``FlowSolver2d``, ``interop``'s
sphere mesh and solver, and ``mesh/gmsh.py`` on hand-written 2.2 and 4.1
files.

Tolerances: the icosahedron's numbering and the mesh topology exactly;
the geometry 1e-13 of scale; the spaces' tables and the residual terms
1e-12; one and three Williamson steps 1e-10 of each field's max; the
.msh readers exactly.  ``examples/williamson2/williamson2.py`` at its
regression size runs through the port against its own bound; the
reference's ladders (``tests/test_williamson.py``, all ``slow``) run
through the port under ``-m slow``; its unsteady cases close the file,
each under the reference test's own name and bounds: Lauter et al.
(2005) example 3 (one day at refinements 3 and 4, the error falling under
0.7 of the coarser one's; minutes on the CPU, ``slow``) and Williamson 5
(10 h at refinement 2 under bdm-dg: bounded, the volume to 1e-9, the
mountain's disturbance over 1 m; seconds, tier-1)."""
import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402
from thetis_tpu.equations.shallowwater_rtdg import (  # noqa: E402
    ShallowWaterEquationsRTDG as JRTDG)
from thetis_tpu.fem.bdm import BDMSpace as JBDM  # noqa: E402
from thetis_tpu.fem.rt import RTSpace as JRT  # noqa: E402
from thetis_tpu.mesh import gmsh as jgmsh  # noqa: E402
from thetis_tpu.mesh import sphere as jsphere  # noqa: E402
from thetis_tpu.model.flowsolver2d import FlowSolver2d as JFS2d  # noqa: E402
from thetis_tpu.solvers.newton import NewtonParameters as JNP  # noqa: E402
import thetis_tpu_torch as T  # noqa: E402
from thetis_tpu_torch.equations.shallowwater_rtdg import (  # noqa: E402
    ShallowWaterEquationsRTDG as TRTDG)
from thetis_tpu_torch.fem.bdm import BDMSpace as TBDM  # noqa: E402
from thetis_tpu_torch.fem.rt import RTSpace as TRT  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver2d_from_reference, sphere_mesh_from_reference)
from thetis_tpu_torch.mesh import gmsh as tgmsh  # noqa: E402
from thetis_tpu_torch.mesh import sphere as tsphere  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import (  # noqa: E402
    FlowSolver2d as TFS2d)
from thetis_tpu_torch.solvers.newton import NewtonParameters as TNP  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401
from test_torch_convergence2d import reference_suite  # noqa: E402

F64 = torch.float64
R_EARTH = 6371220.0
OMEGA = 7.292e-5
G = 9.81


def tensor(v):
    return torch.as_tensor(np.array(v), dtype=F64)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def spheres():
    """refinement -> (reference, port) icosahedral spheres of radius R."""
    return {r: (jsphere.IcosahedralSphereMesh(R_EARTH, r),
                tsphere.IcosahedralSphereMesh(R_EARTH, r, device="cpu"))
            for r in (1, 2)}


TOPOLOGY = ("cells_np", "facet_cells_np", "facet_variant_np",
            "facet_local_np", "cell_facets_np", "cell_sides_np",
            "facet_verts_np", "facet_is_boundary_np", "facet_marker_np")
GEOMETRY = ("coords_np", "detJ_np", "cell_area_np", "cell_normal_np",
            "facet_len_np", "facet_normal_np", "facet_l_normal_np",
            "cell_hmin_np", "cell_hmax_np")


@pytest.mark.parametrize("refinement", [1, 2])
def test_sphere_mesh_matches_reference(spheres, refinement):
    """The icosahedron's numbering and every table: topology exactly,
    geometry to 1e-13 of scale; the device copies."""
    jm, tm = spheres[refinement]
    assert (tm.nv, tm.nc, tm.nf) == (jm.nv, jm.nc, jm.nf)
    assert tm.nc == 20 * 4 ** refinement and tm.geometric_dimension == 3
    for name in TOPOLOGY:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    for name in GEOMETRY:
        close(getattr(tm, name), getattr(jm, name), 1e-13)
    for name in ("cell_normal", "facet_normal", "detJ", "facet_len"):
        close(getattr(tm, name), getattr(tm, name + "_np"), 0.0)
    assert tm.boundary_markers == [] and tm.boundary_len == {}
    assert tm.total_area == pytest.approx(jm.total_area, rel=1e-15)
    close(tm.cell_midpoints(), jm.cell_midpoints(), 1e-15)


def test_sphere_orientation_and_normals(spheres):
    """Cells counter-clockwise seen from outside (outward normals), facet
    normals unit, tangent to both cells' planes on average and out of the
    side-0 cell; the areas sum to the sphere's (to the faceting)."""
    _, tm = spheres[2]
    p = tm.coords_np[tm.cells_np]
    out = (tm.cell_normal_np * p.mean(axis=1)).sum(1)
    assert (out > 0).all()
    n = tm.facet_normal_np
    assert np.abs(np.linalg.norm(n, axis=1) - 1).max() < 1e-13
    fc = tm.facet_cells_np
    cent0 = tm.coords_np[tm.cells_np[fc[:, 0]]].mean(axis=1)
    mid = tm.coords_np[tm.facet_verts_np].mean(axis=1)
    assert (((mid - cent0) * n).sum(1) > 0).all()
    area = 4 * np.pi * R_EARTH ** 2
    assert 0.9 * area < tm.total_area < area


def test_sphere_mesh_goes_to_the_card(monkeypatch):
    """The facade's rule: the card unless ``device=`` says otherwise;
    without one a mesh built with no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsphere.IcosahedralSphereMesh(1.0, 1)
    m = tsphere.IcosahedralSphereMesh(1.0, 1, device="cpu",
                                      dtype=torch.float32)
    assert m.device.type == "cpu" and m.cell_normal.dtype == torch.float32
    assert m.cells.dtype == torch.int64


def test_interop_sphere_mesh(spheres):
    jm, _ = spheres[1]
    tm = sphere_mesh_from_reference(jm, "cpu", F64)
    for name in TOPOLOGY + GEOMETRY:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert tm.radius == jm.radius


def quad_shim(pkg_elements):
    from types import SimpleNamespace

    return SimpleNamespace(space=SimpleNamespace(
        _tab_np=pkg_elements[("DG", 1)].tabulate(3)))


@pytest.fixture(scope="module")
def sphere_spaces(spheres):
    from thetis_tpu.fem.reference_element import ELEMENTS as JEL
    from thetis_tpu_torch.fem.reference_element import ELEMENTS as TEL

    jm, tm = spheres[1]
    return {"rt": (JRT(jm, quad_shim(JEL)), TRT(tm, quad_shim(TEL))),
            "bdm": (JBDM(jm, quad_shim(JEL)), TBDM(tm, quad_shim(TEL)))}


@pytest.mark.parametrize("kind", ["rt", "bdm"])
def test_sphere_spaces_match_reference(sphere_spaces, kind):
    """Tables, evaluation, the scatters and the mass of RT1 / BDM1 on the
    tangent planes (gdim 3)."""
    js, ts = sphere_spaces[kind]
    assert ts.gdim == 3
    for name in ("psi_q", "psi_tr", "div", "Mloc", "wdetJ", "wlen"):
        close(getattr(ts, name), getattr(js, name), 1e-12)
    rng = np.random.default_rng(7)
    U = rng.standard_normal(tuple(ts.dof_shape()))
    for name in ("cell_values", "cell_div", "facet_traces", "facet_un_quad",
                 "mass_apply", "mass_inverse"):
        close(getattr(ts, name)(tensor(U)),
              getattr(js, name)(jnp.asarray(U)), 1e-12)
    nc, nf = ts.mesh.nc, ts.mesh.nf
    nq, nqf = ts.wdetJ.shape[1], ts.wlen.shape[1]
    for name, shape in (("cell_to_dofs", (nc, nq, 3)),
                        ("facet_to_dofs", (nf, 2, nqf, 3)),
                        ("div_to_dofs", (nc, nq))):
        x = rng.standard_normal(shape)
        close(getattr(ts, name)(tensor(x)),
              getattr(js, name)(jnp.asarray(x)), 1e-12)
    uvec = rng.standard_normal((ts.mesh.nv, 3))
    close(ts.project_vector(tensor(uvec)),
          js.project_vector(jnp.asarray(uvec)), 1e-12)


def williamson_inputs(mesh, rng=None):
    """Williamson 2's analytic state (cell-mean elevation, vertex
    velocity, vertex Coriolis) and, with ``rng``, a perturbation."""
    u0 = 2 * np.pi * R_EARTH / (12.0 * 86400.0)
    xyz = mesh.coords_np
    cent = mesh.cell_midpoints()
    sin_lat = cent[:, 2] / np.linalg.norm(cent, axis=1)
    amp = (R_EARTH * OMEGA * u0 + 0.5 * u0 ** 2) / G
    eta0 = (-amp * sin_lat ** 2)[:, None]
    uvec = (u0 / R_EARTH) * np.stack(
        [-xyz[:, 1], xyz[:, 0], np.zeros(mesh.nv)], axis=-1)
    if rng is not None:
        eta0 = eta0 + 20.0 * rng.standard_normal(eta0.shape)
        uvec = uvec + 5.0 * rng.standard_normal(uvec.shape)
    cor = 2.0 * OMEGA * xyz[:, 2] / R_EARTH
    return eta0, uvec, cor, amp


TERMS = ["ExternalPressureGradientTerm", "HUDivTerm",
         "HorizontalAdvectionTerm", "CoriolisTerm", "QuadraticDragTerm",
         "LinearDragTerm", "ContinuitySourceTerm", "all"]


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("kind", ["rt", "bdm"])
def test_sphere_residual_matches_reference(sphere_spaces, kind, term):
    """Every term of the rt-dg / bdm-dg SWE on the sphere, the
    cell-normal Coriolis of a vertex-valued f among them."""
    js, ts = sphere_spaces[kind]
    from types import SimpleNamespace

    o = SimpleNamespace(use_nonlinear_equations=True,
                        use_wetting_and_drying=False)
    h0 = 2.94e4 / G
    je = JRTDG(js.mesh, js.asm, js, o, h0)
    te = TRTDG(ts.mesh, ts.asm, ts, o, h0)
    rng = np.random.default_rng(11)
    eta0, uvec, cor, _ = williamson_inputs(ts.mesh, rng)
    state = {"uv": uvec, "elev": eta0}
    old = {"uv": uvec[::-1].copy(), "elev": eta0[::-1].copy()}
    fields = {"coriolis": cor, "quadratic_drag_coefficient": 2.5e-3,
              "linear_drag_coefficient": 1e-5,
              "volume_source": 1e-6 * rng.random(ts.mesh.nv)}
    out = []
    for e, sp, arr in ((je, js, jnp.asarray), (te, ts, tensor)):
        st = {"uv": sp.project_vector(arr(state["uv"])),
              "elev": arr(state["elev"])}
        so = {"uv": sp.project_vector(arr(old["uv"])),
              "elev": arr(old["elev"])}
        f = {k: arr(v) for k, v in fields.items()}
        label = "all" if term == "all" else [term]
        out.append(e.residual(label, st, so, f, f, {}))
    for k in ("uv", "elev"):
        if np.abs(np.asarray(out[0][k])).max() > 0:
            close(out[1][k], out[0][k], 1e-12)
        else:
            assert float(out[1][k].abs().max()) == 0.0


def williamson_solver(pkg_solver, pkg_params, mesh, family, nsteps,
                      arr):
    """Williamson 2 as ``examples/williamson2/williamson2.py`` sets it up
    (dt 900 s, semi-implicit CN, a vertex Coriolis and a vertex
    velocity), ``nsteps`` steps with an export each."""
    eta0, uvec, cor, amp = williamson_inputs(mesh)
    s = pkg_solver(mesh, arr(2.94e4 / G))
    o = s.options
    o.element_family = family
    o.polynomial_degree = 0
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = True
    o.swe_timestepper_options.solver_parameters = pkg_params(
        ksp_rtol=1e-12, ksp_max_it=96, gmres_restart=24)
    o.timestep = 900.0
    o.simulation_export_time = 900.0
    o.simulation_end_time = 900.0 * nsteps
    o.no_exports = True
    o.coriolis_frequency = arr(cor)
    s.assign_initial_conditions(elev=arr(eta0), uv=arr(uvec))
    return s, eta0, amp


def run_states(s):
    out = []
    s.iterate(export_func=lambda: out.append(
        {k: np.array(v) for k, v in s._get_state().items()}))
    return out


@pytest.mark.parametrize("family", ["rt-dg", "bdm-dg"])
def test_williamson_steps_match_reference(family):
    """Steps 1 and 3 of Williamson 2 on the refinement-2 sphere in both
    packages, the port's solver carried across by ``interop``; the
    volume.  (A fresh reference mesh: the reference's SphereMesh caches
    its device arrays on first use, which inside a jit trace caches
    tracers that a second solver on the mesh then leaks.)"""
    jm = jsphere.IcosahedralSphereMesh(R_EARTH, 2)
    ref, _, _ = williamson_solver(JFS2d, JNP, jm, family, 3, jnp.asarray)
    port = flowsolver2d_from_reference(
        ref, sphere_mesh_from_reference(jm, "cpu", F64))
    assert port.asm.space._tab_np["qw"].shape == (4,)
    want, got = run_states(ref), run_states(port)
    assert len(want) == len(got) == 3
    for i in (0, 2):
        for k, v in want[i].items():
            close(got[i][k], v, 1e-10)
    assert port.compute_volume_2d() == pytest.approx(
        ref.compute_volume_2d(), rel=1e-12)


def test_sphere_needs_an_hdiv_family(spheres):
    _, tm = spheres[1]
    s = TFS2d(tm, 100.0)
    s.options.no_exports = True
    s.options.timestep = 1.0
    with pytest.raises(ValueError, match="H\\(div\\)"):
        s.initialize()
    s.options.element_family = "rt-dg"  # p = 1 is planar only
    with pytest.raises(ValueError, match="planar"):
        s.initialize()


def test_port_williamson2_example():
    """``examples/williamson2/williamson2.py`` at its regression size
    (refinement 3, 0.25 day in 24 steps of 900 s) through the port, held
    to its own bound ``l2 < 0.05``; the volume exactly."""
    mesh = tsphere.IcosahedralSphereMesh(R_EARTH, 3, device="cpu")
    s, eta0, amp = williamson_solver(TFS2d, TNP, mesh, "rt-dg", 24,
                                     tensor)
    s.options.swe_timestepper_options.solver_parameters = TNP(
        ksp_rtol=1e-8, ksp_max_it=96, gmres_restart=24)
    s.options.simulation_export_time = 86400.0
    s.initialize()
    v0 = s.compute_volume_2d()
    s.iterate()
    assert s.iteration == 24
    area = mesh.cell_area_np
    err = s.fields.elev_2d.data[:, 0].numpy() - eta0[:, 0]
    l2 = math.sqrt(float((area * err ** 2).sum()) / area.sum()) / amp
    assert np.isfinite(err).all()
    assert l2 < 0.05, l2
    assert abs(s.compute_volume_2d() - v0) <= 1e-12 * abs(v0)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["rt-dg", "bdm-dg"])
def test_port_williamson2_facade(family):
    """``test_williamson.py::test_williamson2_flowsolver_facade``: 6 h at
    refinement 3, volume to 1e-9, error under 0.08."""
    mesh = tsphere.IcosahedralSphereMesh(R_EARTH, 3, device="cpu")
    s, eta0, amp = williamson_solver(TFS2d, TNP, mesh, family, 24, tensor)
    s.options.swe_timestepper_options.solver_parameters = TNP(
        ksp_rtol=1e-9, ksp_max_it=96, gmres_restart=24)
    s.options.simulation_export_time = 6 * 3600.0
    s.initialize()
    v0 = s.compute_volume_2d()
    s.iterate()
    v1 = s.compute_volume_2d()
    area = mesh.cell_area_np
    err = s.fields.elev_2d.data[:, 0].numpy() - eta0[:, 0]
    rel = math.sqrt(float((area * err ** 2).sum()) / area.sum()) / amp
    assert abs(v1 - v0) < 1e-9 * abs(v0)
    assert rel < 0.08, rel


@pytest.mark.slow
def test_port_williamson2_steady_state():
    """``test_williamson.py::test_williamson2_steady_state``: one day at
    refinements 3 and 4; error under 0.12 and first order."""
    rels = []
    for refinement in (3, 4):
        mesh = tsphere.IcosahedralSphereMesh(R_EARTH, refinement,
                                             device="cpu")
        s, eta0, amp = williamson_solver(TFS2d, TNP, mesh, "rt-dg", 96,
                                         tensor)
        s.options.swe_timestepper_options.solver_parameters = TNP(
            ksp_rtol=1e-9, ksp_max_it=96, gmres_restart=24)
        s.options.simulation_export_time = 86400.0
        s.initialize()
        v0 = s.compute_volume_2d()
        s.iterate()
        area = mesh.cell_area_np
        err = s.fields.elev_2d.data[:, 0].numpy() - eta0[:, 0]
        rels.append(math.sqrt(float((area * err ** 2).sum()) / area.sum())
                    / amp)
        assert abs(s.compute_volume_2d() - v0) / area.sum() < 1e-10
    assert rels[0] < 0.12, rels
    assert rels[1] < 0.65 * rels[0], rels


# -- gmsh -----------------------------------------------------------------
MSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
6
1 0 0 0
2 2 0 0
3 2 1 0
4 0 1 0
5 1 0 0
6 1 1 0
$EndNodes
$Elements
10
1 1 2 100 1 1 5
2 1 2 100 1 5 2
3 1 2 200 2 2 3
4 1 2 100 3 3 6
5 1 2 100 3 6 4
6 1 2 300 4 4 1
7 2 2 7 1 1 5 6
8 2 2 7 1 1 6 4
9 2 2 8 1 5 2 3
10 2 2 8 1 5 3 6
$EndElements
"""

MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 2 2 0
1 0 0 0 2 0 0 1 100 2 1 -2
2 2 0 0 2 1 0 1 200 2 2 -3
1 0 0 0 1 1 0 1 7 0
2 1 0 0 2 1 0 1 8 0
$EndEntities
$Nodes
2 6 1 6
2 1 0 4
1
2
3
4
0 0 0
2 0 0
2 1 0
0 1 0
2 2 0 2
5
6
1 0 0
1 1 0
$EndNodes
$Elements
4 8 1 8
1 1 1 2
1 1 5
2 5 2
1 2 1 2
3 2 3
4 3 6
2 1 2 2
5 1 5 6
6 1 6 4
2 2 2 2
7 5 2 3
8 5 3 6
$EndElements
"""


@pytest.mark.parametrize("fmt", ["2.2", "4.1"])
def test_read_msh_matches_reference(tmp_path, fmt):
    """A hand-written two-region rectangle in each format: nodes, cells,
    boundary markers and lengths, cell region markers: exactly."""
    path = tmp_path / f"box{fmt}.msh"
    path.write_text(MSH22 if fmt == "2.2" else MSH41)
    jm = jgmsh.read_msh(str(path))
    tm = tgmsh.read_msh(str(path), device="cpu")
    assert (tm.nv, tm.nc) == (jm.nv, jm.nc) == (6, 4)
    for name in ("coords_np", "cells_np", "facet_marker_np",
                 "facet_cells_np", "cell_markers_np", "detJ_np"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert tm.boundary_markers == jm.boundary_markers
    assert tm.boundary_len == jm.boundary_len
    assert sorted(set(tm.cell_markers_np)) == [7, 8]
    assert tm.device.type == "cpu" and tm.name == str(path)


def test_read_msh_goes_to_the_card(tmp_path, monkeypatch):
    path = tmp_path / "box.msh"
    path.write_text(MSH22)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgmsh.Mesh(str(path))
    m = tgmsh.Mesh(str(path), device="cpu", dtype=torch.float32)
    assert m.detJ.dtype == torch.float32 and m.nc == 4


def test_msh_mesh_steps_like_reference(tmp_path):
    """One dg-dg SWE step (SSPRK33) on a read mesh (an ``elev`` boundary
    on the .msh file's physical line 100) in both packages, 1e-10."""
    import thetis_tpu as J

    path = tmp_path / "box.msh"
    path.write_text(MSH41)
    out = []
    for pkg, mesh in ((J, jgmsh.read_msh(str(path))),
                      (T, tgmsh.read_msh(str(path), device="cpu"))):
        s = pkg.solver2d.FlowSolver2d(mesh, 10.0)
        o = s.options
        o.swe_timestepper_type = "SSPRK33"
        o.timestep = 0.01
        o.simulation_export_time = 0.01
        o.simulation_end_time = 0.01
        o.no_exports = True
        s.bnd_functions["shallow_water"] = {100: {"elev": 0.1}}
        s.iterate()
        out.append({k: np.array(v) for k, v in s._get_state().items()})
    for k in ("uv", "elev"):
        close(out[1][k], out[0][k], 1e-10)
    assert np.abs(out[0]["uv"]).max() > 1e-6


# -- the reference's unsteady sphere cases (tests/test_williamson.py) ----
def sphere_solver(mesh, bath, family, dt, hours, ksp_rtol):
    """The facade on ``mesh`` as the reference test sets it: an H(div)
    family at degree 0, the semi-implicit CN, the Coriolis 2 Omega
    sin(lat) at the vertices."""
    w = reference_suite("test_williamson")
    s = TFS2d(mesh, tensor(bath))
    o = s.options
    o.element_family = family
    o.polynomial_degree = 0
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = True
    o.swe_timestepper_options.solver_parameters = TNP(
        ksp_rtol=ksp_rtol, ksp_max_it=96, gmres_restart=24)
    o.timestep = dt
    o.simulation_export_time = hours * 3600.0
    o.simulation_end_time = hours * 3600.0
    o.no_exports = True
    o.coriolis_frequency = tensor(2.0 * w.OMEGA * mesh.coords_np[:, 2]
                                  / w.R_EARTH)
    return s


def run_lauter3(refinement, dt=900.0, hours=24.0):
    """``test_williamson.py::run_lauter3`` through the port."""
    w = reference_suite("test_williamson")
    mesh = tsphere.IcosahedralSphereMesh(w.R_EARTH, refinement, device="cpu")
    uv0, eta0, bath = w._lauter3_state(mesh, 0.0)
    s = sphere_solver(mesh, bath, "rt-dg", dt, hours, 1e-9)
    s.assign_initial_conditions(elev=tensor(eta0), uv=tensor(uv0))
    s.iterate()
    _, eta_t, _ = w._lauter3_state(mesh, s.simulation_time)
    area = np.asarray(mesh.cell_area_np)
    err = s.fields.elev_2d.data[:, 0].numpy() - eta_t[:, 0]
    return (math.sqrt(float((area * err ** 2).sum()) / area.sum())
            / float(np.abs(eta_t).max()))


@pytest.mark.slow
def test_lauter3_unsteady():
    r3, r4 = run_lauter3(3), run_lauter3(4)
    print(f"port lauter3: rel elev err ref3 {r3:.4f} ref4 {r4:.4f}")
    assert np.isfinite([r3, r4]).all()
    assert r4 < 0.7 * r3, (r3, r4)


def test_williamson5_facade():
    """Williamson (1992) case 5 at refinement 2 (bdm-dg, dt 3600 s, 10
    h): bounded, the volume kept, the mountain's disturbance."""
    w = reference_suite("test_williamson")
    depth, u_max = 5960.0, 20.0
    mesh = tsphere.IcosahedralSphereMesh(w.R_EARTH, 2, device="cpu")
    xyz = mesh.coords_np
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    lat = np.arcsin(np.clip(xyz[:, 2] / w.R_EARTH, -1, 1))
    r0 = np.pi / 9.0
    lon_c, lat_c = -np.pi / 2.0, np.pi / 6.0
    r = np.sqrt(np.minimum(r0 ** 2, (lon - lon_c) ** 2 + (lat - lat_c) ** 2))
    bath = depth - 2000.0 * (1 - r / r0)
    amp = (w.R_EARTH * w.OMEGA * u_max + 0.5 * u_max ** 2) / w.G
    cent = mesh.cell_midpoints()
    sin_lat_c = cent[:, 2] / np.linalg.norm(cent, axis=1)
    eta0 = (-amp * sin_lat_c ** 2)[:, None]
    uvec = (u_max / w.R_EARTH) * np.stack(
        [-xyz[:, 1], xyz[:, 0], np.zeros(mesh.nv)], axis=-1)
    eta_v = -amp * (xyz[:, 2] / w.R_EARTH) ** 2
    uvec = uvec * ((depth + eta_v) / (bath + eta_v))[:, None]
    s = sphere_solver(mesh, bath, "bdm-dg", 3600.0, 10.0, 1e-8)
    s.assign_initial_conditions(elev=tensor(eta0), uv=tensor(uvec))
    s.initialize()
    v0 = s.compute_volume_2d()
    s.iterate()
    v1 = s.compute_volume_2d()
    elev = s.fields.elev_2d.data[:, 0].numpy()
    assert np.isfinite(elev).all()
    assert abs(v1 - v0) < 1e-9 * abs(v0), "volume not conserved"
    assert np.abs(elev).max() < 3000.0
    assert float(np.abs(elev - eta0[:, 0]).max()) > 1.0, "no mountain response"
