"""The GLS turbulence closure of ``thetis_tpu_torch`` against
``thetis_tpu`` (f64, CPU): the same numpy arrays, made from a seed, go
through the JAX function and its counterpart in the port.

Tolerances: the host-side parameters of the seven stability-function
families rtol 1e-14 (Python floats on both sides, the same expressions);
``evaluate`` rtol 1e-12; the closure's functions (the derived options,
``psi_from_k_eps``, ``eps_from_k_psi``, ``limit_psi``,
``eddy_coefficients``, ``step_columns``, ``compute_shear_buoy_freq``, the
Pacanowski-Philander model) rtol 1e-11; 20 chained steps of the
reference's column spin-up rtol 1e-9.  One f32 case holds the port alone:
finite outputs with k and psi on their floors, where the normalised
frequencies reach 1e12."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu.equations import stability_functions as jsf  # noqa: E402
from thetis_tpu.equations import turbulence as jturb  # noqa: E402
from thetis_tpu.fem.assembly import DGAssembler as JAsm  # noqa: E402
from thetis_tpu.fem.assembly3d import Assembler3D as JA3  # noqa: E402
from thetis_tpu.fem.functionspace import FunctionSpace as JFS  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.mesh.extruded import ExtrudedMesh as JExt  # noqa: E402
from thetis_tpu_torch.equations import stability_functions as tsf  # noqa: E402
from thetis_tpu_torch.equations import turbulence as tturb  # noqa: E402
from thetis_tpu_torch.fem.assembly import DGAssembler as TAsm  # noqa: E402
from thetis_tpu_torch.fem.assembly3d import Assembler3D as TA3  # noqa: E402
from thetis_tpu_torch.fem.functionspace import FunctionSpace as TFS  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.mesh.extruded import ExtrudedMesh as TExt  # noqa: E402

F64 = torch.float64
FAMILIES = sorted(jsf.STABILITY_FUNCTIONS)
CLOSURES = ("k-epsilon", "k-omega", "Generic Length Scale")
#: limiter switches of ``evaluate``: the default smooth alpha_N limit, the
#: hard one, and none at all
LIMITERS = {
    "smooth": {},
    "hard": dict(smooth_alpha_buoy_lim=False),
    "off": dict(lim_alpha_shear=False, lim_alpha_buoy=False),
}
SHAPE = (5, 3, 6, 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def log_uniform(rng, lo, hi, shape=SHAPE):
    return 10.0 ** rng.uniform(lo, hi, size=shape)


def turbulence_inputs(seed):
    """Random (m2, n2, k, eps): n2 of both signs, eight decades of each."""
    rng = np.random.default_rng(seed)
    m2 = log_uniform(rng, -8, -2)
    n2 = log_uniform(rng, -8, -3) * rng.choice([-1.0, 1.0], size=SHAPE)
    k = log_uniform(rng, -6, -2)
    eps = log_uniform(rng, -10, -4)
    return m2, n2, k, eps


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


# -- stability functions ------------------------------------------------
def test_same_families():
    assert sorted(tsf.STABILITY_FUNCTIONS) == FAMILIES
    assert len(FAMILIES) == 7


@pytest.mark.parametrize("name", FAMILIES)
def test_host_parameters(name):
    j, t = jsf.STABILITY_FUNCTIONS[name](), tsf.STABILITY_FUNCTIONS[name]()
    assert t.name == j.name == name
    jo, to = jturb.GLSModelOptions(), tturb.GLSModelOptions()
    cmu0 = float(j.compute_cmu0())
    calls = {
        "compute_cmu0": (),
        "compute_c3_minus": (jo.c1, jo.c2, jo.ri_st),
        "compute_kappa": (jo.schmidt_nb_psi, cmu0, jo.n, jo.c1, jo.c2),
        "compute_sigma_psi": (jo.kappa, cmu0, jo.n, jo.c1, jo.c2),
        "compute_length_clim": (cmu0, jo.ri_st),
        "get_alpha_buoy_min": (),
        "compute_alpha_shear_steady": (jo.ri_st,),
    }
    assert vars(to) == vars(jo)
    for fn, args in calls.items():
        got = getattr(t, fn)(*args)
        assert isinstance(got, float), fn  # never a numpy scalar
        np.testing.assert_allclose(got, float(getattr(j, fn)(*args)),
                                   rtol=1e-14, err_msg=fn)


@pytest.mark.parametrize("limiter", sorted(LIMITERS))
@pytest.mark.parametrize("name", FAMILIES)
def test_evaluate(name, limiter):
    kw = LIMITERS[limiter]
    j = jsf.STABILITY_FUNCTIONS[name](**kw)
    t = tsf.STABILITY_FUNCTIONS[name](**kw)
    ja, ta = both(turbulence_inputs(FAMILIES.index(name)))
    for got, want in zip(t.evaluate(*ta), j.evaluate(*ja)):
        close(got, want, 1e-12)
    jab, jas = jsf.compute_normalized_frequencies(*ja)
    tab, tas = tsf.compute_normalized_frequencies(*ta)
    close(tab, jab, 1e-14)
    close(tas, jas, 1e-14)
    assert float(tab.min()) < t.alpha_buoy_crit < 0 < float(tab.max())
    close(t.get_alpha_shear_max(tab), j.get_alpha_shear_max(jab), 1e-12)
    close(t.get_alpha_buoy_smooth_min(tab), j.get_alpha_buoy_smooth_min(jab),
          1e-12)


def test_eval_funcs_takes_floats_and_tensors():
    t = tsf.StabilityFunctionCanutoA()
    s_m, s_h = t.eval_funcs(0.3, 2.0)
    assert isinstance(s_m, float) and isinstance(s_h, float)
    a, b = torch.tensor([0.3], dtype=F64), torch.tensor([2.0], dtype=F64)
    tm, th = t.eval_funcs(a, b)
    assert float(tm) == s_m and float(th) == s_h
    f32 = t.eval_funcs(a.float(), b.float())
    assert f32[0].dtype == torch.float32


# -- the closure --------------------------------------------------------
def models(closure, **kw):
    j = jturb.GenericLengthScaleModel(
        None, jturb.GLSModelOptions(closure_name=closure, **kw))
    t = tturb.GenericLengthScaleModel(
        None, tturb.GLSModelOptions(closure_name=closure, **kw))
    return j, t


@pytest.mark.parametrize("family", ["Canuto A", "Kantha-Clayson"])
@pytest.mark.parametrize("closure", CLOSURES)
def test_derived_options(closure, family):
    j, t = models(closure, stability_function_name=family)
    jo, to = vars(j.options), vars(t.options)
    assert sorted(jo) == sorted(to)
    for key, want in jo.items():
        if isinstance(want, float):
            np.testing.assert_allclose(to[key], want, rtol=1e-14, err_msg=key)
        else:
            assert to[key] == want, key
    j2, t2 = models(closure, stability_function_name=family,
                    compute_kappa=True)
    np.testing.assert_allclose(t2.options.kappa, j2.options.kappa,
                               rtol=1e-14)


@pytest.mark.parametrize("closure", CLOSURES)
def test_psi_from_k_eps_takes_numbers(closure):
    """A number for the dissipation (or for both), as the reference takes
    it (``tests/test_turbulence.py::test_gls_column_spinup`` seeds psi so):
    the port clipped it with ``torch.clamp_min``, which refuses a number."""
    j, t = models(closure)
    k = log_uniform(np.random.default_rng(3), -6, -3)
    for kk, eps in ((k, 1e-9), (1e-4, 2.5e-8), (k, 0.0)):
        want = j.psi_from_k_eps(jnp.asarray(kk), eps)
        got = t.psi_from_k_eps(torch.as_tensor(kk) if np.ndim(kk) else kk,
                               eps)
        assert got.dtype == F64
        close(got, want, 1e-13)


def closure_inputs(j, seed):
    """(k, psi, m2, n2, nu, mu, Dn) for the closure's functions: psi from
    a random dissipation, some k and psi below their floors.  The
    turbulent time scale k/eps is drawn from 1 s to 1000 s, so that the
    normalised frequencies stay below 1e3: the smooth alpha_N limiter
    subtracts two numbers of alpha_N's size, which amplifies the last-bit
    differences between the two packages' ``pow`` by that size
    (``test_evaluate`` covers the wide range, on identical inputs)."""
    rng = np.random.default_rng(seed + 100)
    m2 = log_uniform(rng, -8, -3)
    n2 = log_uniform(rng, -8, -3) * rng.choice([-1.0, 1.0], size=SHAPE)
    k = log_uniform(rng, -6, -2)
    eps = k / log_uniform(rng, 0, 3)
    psi = np.array(j.psi_from_k_eps(jnp.asarray(k), jnp.asarray(eps)))
    k[rng.random(SHAPE) < 0.1] = 1e-8
    # psi below its floor only under stable stratification: on the floor
    # k/eps is 1e8 s, and an unstable N^2 then gives alpha_N ~ -1e12
    psi[(rng.random(SHAPE) < 0.2) & (n2 > 0)] = 1e-16
    nu = log_uniform(rng, -7, -2)
    mu = log_uniform(rng, -7, -2)
    Dn = rng.uniform(0.5, 3.0, size=SHAPE[:3])
    return k, psi, m2, n2, nu, mu, Dn


FUNCTIONS = {
    "psi_from_k_eps": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.psi_from_k_eps(k, nu),),
    "length_from_k_eps": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.length_from_k_eps(k, nu * 1e-4),),
    "eps_from_k_psi": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.eps_from_k_psi(k, psi)),
    "eps_from_k_psi_buoy2": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.eps_from_k_psi(k, psi, n2)),
    "limit_psi": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.limit_psi(k, psi, n2),),
    "eddy_coefficients": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.eddy_coefficients(k, psi, m2, n2)),
    "step_columns": lambda m, k, psi, m2, n2, nu, mu, Dn: (
        m.step_columns(k, psi, m2, n2, nu, mu, Dn, 30.0)),
}


@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
@pytest.mark.parametrize("closure", CLOSURES)
def test_closure_function(closure, fn):
    j, t = models(closure)
    arrays = closure_inputs(j, CLOSURES.index(closure))
    ja, ta = both(arrays)
    before = [a.clone() for a in ta]
    got, want = FUNCTIONS[fn](t, *ta), FUNCTIONS[fn](j, *ja)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        close(g, w, 1e-11)
    for a, b in zip(ta, before):  # nothing given was written into
        assert torch.equal(a, b)


def test_limit_psi_positive_exponent():
    """A closure with n > 0 caps psi from above (no stock closure has
    one)."""
    j, t = models("Generic Length Scale", n=0.67)
    ja, ta = both(closure_inputs(j, 9)[:4])
    close(t.limit_psi(ta[0], ta[1], ta[3]), j.limit_psi(ja[0], ja[1], ja[3]),
          1e-11)


def test_no_limit_psi_option():
    j, t = models("k-epsilon", limit_psi=False)
    ja, ta = both(closure_inputs(j, 3)[:4])
    for g, w in zip(t.eddy_coefficients(*ta), j.eddy_coefficients(*ja)):
        close(g, w, 1e-11)


@pytest.fixture(scope="module")
def column():
    """The reference's column spin-up mesh (tests/test_turbulence.py): 2x2
    rectangle, 20 layers, 50 m deep."""
    jm = jgen.RectangleMesh(2, 2, 100.0, 100.0)
    tm = tgen.RectangleMesh(2, 2, 100.0, 100.0, device="cpu", dtype=F64)
    ja = JA3(jm, JAsm(jm, JFS(jm, "DG", 1)), JExt(jm, n_layers=20))
    ta = TA3(tm, TAsm(tm, TFS(tm, "DG", 1)), TExt(tm, 20))
    jg = ja.layer_geometry(ja.ext.z_interfaces(
        jnp.full((jm.nc, 3), 50.0), jnp.zeros((jm.nc, 3))))
    tg = ta.layer_geometry(ta.ext.z_interfaces(
        torch.full((tm.nc, 3), 50.0, dtype=F64),
        torch.zeros((tm.nc, 3), dtype=F64)))
    return jm, ja, ta, jg, tg


@pytest.mark.parametrize("closure", CLOSURES)
def test_chained_column_spinup(column, closure):
    """20 chained ``eddy_coefficients`` + ``step_columns`` steps under a
    constant shear from the seed state; the state must move."""
    jm, ja, ta, jg, tg = column
    j = jturb.GenericLengthScaleModel(
        ja, jturb.GLSModelOptions(closure_name=closure))
    t = tturb.GenericLengthScaleModel(
        ta, tturb.GLSModelOptions(closure_name=closure))
    o = j.options
    shape = (jm.nc, 3, 20, 2)
    eps0 = o.cmu0**3 * o.k_min**1.5 / 0.3
    jk = jnp.full(shape, o.k_min)
    jpsi = j.psi_from_k_eps(jk, eps0)
    tk = torch.full(shape, o.k_min, dtype=F64)
    tpsi = t.psi_from_k_eps(tk, torch.full(shape, eps0, dtype=F64))
    close(tpsi, jpsi, 1e-13)
    jm2, jn2 = jnp.full(shape, 1e-4), jnp.zeros(shape)
    tm2 = torch.full(shape, 1e-4, dtype=F64)
    tn2 = torch.zeros(shape, dtype=F64)
    for _ in range(20):
        jnu, jmu, _, _ = j.eddy_coefficients(jk, jpsi, jm2, jn2)
        jk, jpsi = j.step_columns(jk, jpsi, jm2, jn2, jnu, jmu,
                                  jg["Delta_nodes"], 30.0)
        tnu, tmu, _, _ = t.eddy_coefficients(tk, tpsi, tm2, tn2)
        tk, tpsi = t.step_columns(tk, tpsi, tm2, tn2, tnu, tmu,
                                  tg["Delta_nodes"], 30.0)
    assert float(tk.max()) > 10 * o.k_min
    for g, w in ((tk, jk), (tpsi, jpsi), (tnu, jnu), (tmu, jmu)):
        close(g, w, 1e-9)


@pytest.mark.parametrize("with_rho", [True, False])
@pytest.mark.parametrize("kind", ["periodic", "rect"])
def test_shear_buoy_freq(kind, with_rho):
    """M^2, N^2 on an extruded mesh with a sloped bed and a wavy surface,
    random velocity and density."""
    make = {"periodic": lambda g, **kw: g.PeriodicRectangleMesh(
                5, 4, 1e3, 8e2, direction="x", **kw),
            "rect": lambda g, **kw: g.RectangleMesh(4, 3, 1e3, 8e2, **kw)}
    jm = make[kind](jgen)
    tm = make[kind](tgen, device="cpu", dtype=F64)
    nz = 4
    ja = JA3(jm, JAsm(jm, JFS(jm, "DG", 1)), JExt(jm, nz))
    ta = TA3(tm, TAsm(tm, TFS(tm, "DG", 1)), TExt(tm, nz))
    xy = jm.coords_np
    bathy = (20.0 + 30.0 * xy[:, 1] / 8e2
             + 5.0 * np.sin(2 * np.pi * xy[:, 0] / 1e3))[jm.cells_np]
    elev = (0.5 * np.cos(2 * np.pi * xy[:, 0] / 1e3))[jm.cells_np]
    jg = ja.layer_geometry(ja.ext.z_interfaces(jnp.asarray(bathy),
                                               jnp.asarray(elev)))
    tg = ta.layer_geometry(ta.ext.z_interfaces(torch.tensor(bathy),
                                               torch.tensor(elev)))
    rng = np.random.default_rng(11)
    uv = rng.standard_normal((jm.nc, 3, nz, 2, 2)) * 0.1
    rho = rng.standard_normal((jm.nc, 3, nz, 2)) if with_rho else None
    j = jturb.GenericLengthScaleModel(ja)
    t = tturb.GenericLengthScaleModel(ta)
    jm2, jn2 = j.compute_shear_buoy_freq(
        jnp.asarray(uv), None if rho is None else jnp.asarray(rho), jg,
        rho0=1020.0)
    tm2, tn2 = t.compute_shear_buoy_freq(
        torch.tensor(uv), None if rho is None else torch.tensor(rho), tg,
        rho0=1020.0)
    close(tm2, jm2, 1e-11)
    np.testing.assert_allclose(tn2.numpy(), np.asarray(jn2), rtol=1e-11,
                               atol=1e-11 * float(np.abs(jn2).max()))
    assert float(tm2.max()) > 1e-6
    assert (float(tn2.abs().max()) > 0) == with_rho


def test_pacanowski_philander():
    m2, n2, _, _ = turbulence_inputs(21)
    j, t = jturb.PacanowskiPhilanderModel(), tturb.PacanowskiPhilanderModel()
    assert vars(j) == vars(t)
    for g, w in zip(t.eddy_coefficients(torch.tensor(m2), torch.tensor(n2)),
                    j.eddy_coefficients(jnp.asarray(m2), jnp.asarray(n2))):
        close(g, w, 1e-11)


# -- f32: the port alone ------------------------------------------------
@pytest.mark.parametrize("n2", [-1e-4, 0.0, 1e-12, 1e-4])
@pytest.mark.parametrize("closure", CLOSURES)
def test_f32_floors_stay_finite(closure, n2):
    """k and psi on their floors (1e-6, 1e-14), where eps**2 is 1e-28 and
    the normalised frequencies reach 1e12: every output of the closure's
    step stays finite in f32, and above its own floor."""
    _, t = models(closure)
    o = t.options
    f32 = torch.float32
    k = torch.full(SHAPE, o.k_min, dtype=f32)
    psi = torch.full(SHAPE, o.psi_min, dtype=f32)
    m2 = torch.full(SHAPE, 1e-4, dtype=f32)
    n2 = torch.full(SHAPE, n2, dtype=f32)
    Dn = torch.full(SHAPE[:3], 2.5, dtype=f32)
    nu, mu, eps, l = t.eddy_coefficients(k, psi, m2, n2)
    k1, psi1 = t.step_columns(k, psi, m2, n2, nu, mu, Dn, 300.0)
    nu1, mu1, eps1, l1 = t.eddy_coefficients(k1, psi1, m2, n2)
    for name, v in dict(nu=nu, mu=mu, eps=eps, l=l, k1=k1, psi1=psi1,
                        nu1=nu1, mu1=mu1, eps1=eps1, l1=l1).items():
        assert v.dtype == f32, name
        assert bool(torch.isfinite(v).all()), name
        assert float(v.min()) > 0.0, name
