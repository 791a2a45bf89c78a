"""The Rhine ROFI example (``examples/rhineROFI/rhineROFI.py``: LeapFrogAM3,
GLS, Smagorinsky, the tracer limiter, the Kelvin-wave forcing),
``thetis_tpu_torch`` against ``thetis_tpu`` (f64, CPU), at ``coarse=16``
with 2 layers, built by both packages from one description
(``chip_smoke.rofi_description``, the port's solver through
``interop.flowsolver3d_from_numpy``): three steps through
``iterate(update_forcings=...)``, the Kelvin-wave elevation set again
each step.

Tolerance: rtol 1e-8 times each field's scale, as
``tests/test_torch_3d_leapfrog.py``, where the start allows it.  ROFI's
start is ill-conditioned for the closure: its salinity is uniform in the
vertical, so N^2 is roundoff and the sign of the buoyancy flux picks the
psi source's c3 at random; a relative change of 1e-15 in the start's
salinity moves psi by ~5e-6 and nu_v by ~4e-5 of scale in the port
alone.  There the fields the closure reaches (uv_3d, tke, psi and the
eddy coefficients) are held to a tenth of the port's own spread on the
eddy coefficients under a 1e-13 change of the start's salinity (measured
in the test: ~1.7e-4 of scale, so ~1.7e-5); the elevation, the 2D
velocity and the salinity to 1e-8."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import (  # noqa: E402
    pin_mesh_builders, strong_fields)

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from thetis_tpu import config as jconfig  # noqa: E402
from thetis_tpu.fem.functionspace import Function as JFunction  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh.mesh2d import Mesh2d as JMesh2d  # noqa: E402
from thetis_tpu.model.flowsolver3d import FlowSolver as JFlow  # noqa: E402
from thetis_tpu_torch import config as tconfig  # noqa: E402
from thetis_tpu_torch.interop import (  # noqa: E402
    flowsolver3d_from_numpy, state3d_to_numpy)
from thetis_tpu_torch.mesh.mesh2d import Mesh2d as TMesh2d  # noqa: E402
from test_torch_3d_leapfrog import (  # noqa: E402,F401
    F64, RTOL, jax_values, one_torch_thread)


ROFI_STEPS = 3


@pytest.fixture(scope="module")
def rofi_run():
    coords, cells, markers = chip_smoke.rofi_mesh_arrays(16.0)
    d = chip_smoke.rofi_description(coords, cells, 2, ROFI_STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.physical_constants, "rho0", 1000.0)
        mp.setitem(tconfig.physical_constants, "rho0", 1000.0)
        jm = JMesh2d(coords, cells, boundary_markers=markers,
                     name="rhine_rofi")
        tm = TMesh2d(coords, cells, boundary_markers=markers,
                     name="rhine_rofi", device="cpu", dtype=F64)
        kelvin = JFunction(JFS(jm, "CG", 1))
        kelvin.data = jnp.asarray(d["kelvin"](0.0))
        bnd = {w: {m: {k: kelvin if v == "kelvin" else v
                       for k, v in sp.items()} for m, sp in specs.items()}
               for w, specs in d["bnd"].items()}
        js = JFlow(jm, jnp.asarray(d["bathymetry"]), 2)
        js.options.update(jax_values(d["options"]))
        for which, specs in bnd.items():
            js.bnd_functions[which] = specs
        ts = flowsolver3d_from_numpy(tm, d["bathymetry"], 2, d["options"],
                                     bnd_functions=bnd)
        t_kelvin = ts.bnd_functions["shallow_water"][1]["elev"]
        assert all(ts.bnd_functions["shallow_water"][m]["elev"] is t_kelvin
                   for m in (1, 2, 3))
        ics = dict(elev=d["elev"], uv_2d=d["uv"], salt=d["salt"])
        js.assign_initial_conditions(**jax_values(ics))
        strong_fields(js)  # one compile of the reference's step, not two
        ts.assign_initial_conditions(**ics)

        def j_forcing(t):
            kelvin.data = jnp.asarray(d["kelvin"](t))

        def t_forcing(t):
            t_kelvin.data = torch.tensor(d["kelvin"](t))

        js.iterate(update_forcings=j_forcing)
        bathy_cell = d["bathymetry"][cells]
        fw0 = chip_smoke.rofi_freshwater(ts, bathy_cell)
        ts.iterate(update_forcings=t_forcing)
        fw1 = chip_smoke.rofi_freshwater(ts, bathy_cell)
        # the port again, its start's salinity changed by 1e-13 (relative:
        # above the roundoff that separates the two packages)
        again = flowsolver3d_from_numpy(tm, d["bathymetry"], 2,
                                        d["options"], bnd_functions=bnd)
        noise = np.random.default_rng(0).standard_normal(d["salt"].shape)
        again.assign_initial_conditions(**dict(
            ics, salt=d["salt"] * (1 + 1e-13 * noise)))
        a_kelvin = again.bnd_functions["shallow_water"][1]["elev"]
        a_kelvin.data = torch.tensor(d["kelvin"](0.0))

        def a_forcing(t):
            a_kelvin.data = torch.tensor(d["kelvin"](t))

        again.iterate(update_forcings=a_forcing)
    got = state3d_to_numpy(ts._get_state())
    spread = {k: np.abs(v - got[k]).max() for k, v in
              state3d_to_numpy(again._get_state()).items()}
    return dict(js=js, ts=ts, fw=(fw0, fw1), spread=spread, got=got,
                want={k: np.asarray(v) for k, v in
                      js._get_state().items()})


#: the fields the closure's start reaches in three steps
ROFI_CLOSURE = ("uv_3d", "tke_3d", "psi_3d", "nu_v_3d", "mu_v_3d")


def rofi_sensitivity(r):
    """The port's own spread on the eddy coefficients under the 1e-13
    change of the start's salinity, relative to their scale."""
    return max(r["spread"][k] / np.abs(r["got"][k]).max()
               for k in ("nu_v_3d", "mu_v_3d"))


def test_rofi_start_is_ill_conditioned(rofi_run):
    """What the looser tolerance below rests on: the start's roundoff
    alone moves the eddy coefficients far above 1e-8."""
    assert rofi_sensitivity(rofi_run) > 1e-6


@pytest.mark.parametrize("key", ("elev", "uv", "salt_3d") + ROFI_CLOSURE)
def test_rofi_iterate_matches_reference(rofi_run, key):
    """1e-8 of scale, or for the fields the closure reaches a tenth of the
    port's own spread on the eddy coefficients, whichever is larger."""
    g, w = rofi_run["got"][key], rofi_run["want"][key]
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    rtol = RTOL
    if key in ROFI_CLOSURE:
        rtol = max(RTOL, 0.1 * rofi_sensitivity(rofi_run))
    np.testing.assert_allclose(g, w, rtol=0.0,
                               atol=rtol * np.abs(w).max())


def test_rofi_fields_and_diagnostics(rofi_run):
    """The example's own checks (rhineROFI.py:234-246) and the w and the
    monitors of the last export, against the reference's."""
    ts, js = rofi_run["ts"], rofi_run["js"]
    assert ts.iteration == js.iteration == ROFI_STEPS
    salt = rofi_run["got"]["salt_3d"]
    assert salt.min() > -0.01 and salt.max() < 32.01
    fw0, fw1 = rofi_run["fw"]
    assert abs(fw1 - fw0) / max(abs(fw0), 1.0) < 0.05
    w_ref = np.asarray(js.fields.w_3d.data)
    np.testing.assert_allclose(ts.fields.w_3d.data.numpy(), w_ref,
                               rtol=RTOL, atol=RTOL * np.abs(w_ref).max())
    assert sorted(ts.callbacks["export"]) == sorted(js.callbacks["export"])


_DRIFT = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", sys.argv[1] == "64")
import jax.numpy as jnp
import torch
import chip_smoke
from thetis_tpu import config as jc
from thetis_tpu.fem.functionspace import Function, FunctionSpace
from thetis_tpu.mesh.mesh2d import Mesh2d
from thetis_tpu.model.flowsolver3d import FlowSolver
torch.set_num_threads(2)
jc.physical_constants["rho0"] = 1000.0
coarse, layers, steps = 4.0, 4, 100
coords, cells, markers = chip_smoke.rofi_mesh_arrays(coarse)
d = chip_smoke.rofi_description(coords, cells, layers, steps)
dtype = torch.float64 if sys.argv[1] == "64" else torch.float32
s, forcing, bc = chip_smoke.rofi_solver("cpu", dtype, coarse=coarse,
                                        layers=layers, steps=steps)
fw0 = chip_smoke.rofi_freshwater(s, bc)
s.iterate(update_forcings=forcing)
port = (chip_smoke.rofi_freshwater(s, bc) - fw0) / fw0
jm = Mesh2d(coords, cells, boundary_markers=markers, name="rhine_rofi")
kelvin = Function(FunctionSpace(jm, "CG", 1))
kelvin.data = jnp.asarray(d["kelvin"](0.0))
js = FlowSolver(jm, jnp.asarray(d["bathymetry"]), layers)
js.options.update({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in d["options"].items()})
for which, specs in d["bnd"].items():
    js.bnd_functions[which] = {m: {k: kelvin if v == "kelvin" else v
                                   for k, v in sp.items()}
                               for m, sp in specs.items()}
js.assign_initial_conditions(elev=jnp.asarray(d["elev"]),
                             uv_2d=jnp.asarray(d["uv"]),
                             salt=jnp.asarray(d["salt"]))


def fresh():
    salt = np.asarray(js.fields.salt_3d.data, dtype=np.float64)
    elev = np.asarray(js.fields.elev_2d.data, dtype=np.float64)
    depth = (bc + elev).mean(axis=1)
    return float(((1.0 - salt / 32.0).mean(axis=(1, 2, 3)) * depth
                  * jm.cell_area_np).sum())


def update(t):
    kelvin.data = jnp.asarray(d["kelvin"](t))


f0 = fresh()
js.iterate(update_forcings=update)
print("DRIFT", port, (fresh() - f0) / f0)
"""


@pytest.mark.slow
def test_rofi_f32_freshwater_drift_against_reference():
    """ROFI at coarse 4 with 4 layers, 100 steps, each package in f32 and
    in f64 (each run in a process of its own, JAX's x64 switch set for
    it): in f64 both keep the example's freshwater diagnostic, and agree;
    in f32 both lose some (the ocean's salinity drifts by roundoff and its
    volume multiplies it), the port no more than the reference."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    drift = {}
    for bits in ("32", "64"):
        out = subprocess.run(
            [sys.executable, "-c", _DRIFT, bits], cwd=root,
            capture_output=True, text=True, timeout=1800,
            env=dict(os.environ, PYTHONPATH=root))
        assert out.returncode == 0, out.stderr[-3000:]
        line = [x for x in out.stdout.splitlines() if x.startswith("DRIFT")]
        drift[bits] = tuple(float(v) for v in line[-1].split()[1:])
    print(f"freshwater change (port, reference): f32 {drift['32']}, "
          f"f64 {drift['64']}")
    port64, ref64 = drift["64"]
    assert abs(port64) < 0.05 and abs(port64 - ref64) < 1e-8
    port32, ref32 = drift["32"]
    assert abs(port32) <= abs(ref32)
