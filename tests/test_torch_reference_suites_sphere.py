"""The reference's unsteady sphere cases (``tests/test_williamson.py``)
through ``thetis_tpu_torch`` on the CPU in f64, each under the reference
test's own name and bounds, through the ``FlowSolver2d`` facade on the
icosahedral sphere:

* ``test_lauter3_unsteady``: Lauter et al. (2005) example 3, the
  unsteady solid-body rotation, one day at refinements 3 and 4, the
  error falling under 0.7 of the coarser one's (the analytic state is the
  reference module's ``_lauter3_state``, numpy);
* ``test_williamson5_facade``: Williamson 5, the zonal flow over an
  isolated mountain, 10 h at refinement 2 under bdm-dg: bounded, the
  volume to 1e-9, the mountain's disturbance over 1 m.

The reference marks both ``slow``; on the port the Lauter ladder takes
minutes on the CPU (``slow``), Williamson 5 seconds (tier-1)."""
import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_convergence2d import reference_suite  # noqa: E402
from thetis_tpu_torch.mesh.sphere import IcosahedralSphereMesh  # noqa: E402
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d  # noqa: E402
from thetis_tpu_torch.solvers.newton import NewtonParameters  # noqa: E402
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def tensor(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def sphere_solver(mesh, bath, family, dt, hours, ksp_rtol):
    """The facade on ``mesh`` as the reference test sets it: an H(div)
    family at degree 0, the semi-implicit CN, the Coriolis 2 Omega
    sin(lat) at the vertices."""
    w = reference_suite("test_williamson")
    s = FlowSolver2d(mesh, tensor(bath))
    o = s.options
    o.element_family = family
    o.polynomial_degree = 0
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = True
    o.swe_timestepper_options.solver_parameters = NewtonParameters(
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
    mesh = IcosahedralSphereMesh(w.R_EARTH, refinement, device="cpu")
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
    mesh = IcosahedralSphereMesh(w.R_EARTH, 2, device="cpu")
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
