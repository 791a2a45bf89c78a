"""Port parity: the user API of ``Function`` (``project``, ``copy``,
``dat``, ``+ - *`` both ways, component indexing) against
``thetis_tpu.fem.functionspace.Function`` (f64, CPU).

The same seeded numpy dofs go into a DG1 and a vector DG1 Function of a
small rectangle in both packages; every result is held to the
reference's to 1e-14. The reference returns arrays from its operators,
the port tensors."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import jax.numpy as jnp  # noqa: E402

from thetis_tpu import api as japi  # noqa: E402
from thetis_tpu.mesh import generation as jgen  # noqa: E402
from thetis_tpu.fem.functionspace import (  # noqa: E402
    Function as JFunction, FunctionSpace as JFS)
import thetis_tpu_torch as tapi  # noqa: E402
from thetis_tpu_torch.mesh import generation as tgen  # noqa: E402
from thetis_tpu_torch.fem.functionspace import (  # noqa: E402
    Function as TFunction, FunctionSpace as TFS)

F64 = torch.float64
SPACES = {"DG1": 1, "vector DG1": 2}


def close(got, want, rtol=1e-14):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor), type(got)
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


class Case:
    """A pair of Functions ``f``, ``g`` on one space in each package, and
    a dof-shaped numpy array ``a``, all from one seed."""

    def __init__(self, dim):
        jm = jgen.RectangleMesh(4, 3, 1e3, 8e2)
        tm = tgen.RectangleMesh(4, 3, 1e3, 8e2, device="cpu", dtype=F64)
        self.js, self.ts = JFS(jm, "DG", 1, dim=dim), TFS(tm, "DG", 1,
                                                          dim=dim)
        rng = np.random.default_rng(15 + dim)
        shape = self.ts.dof_shape()
        f, g, self.a = (rng.standard_normal(shape) for _ in range(3))
        self.jf = JFunction(self.js, name="f", data=jnp.asarray(f))
        self.jg = JFunction(self.js, name="g", data=jnp.asarray(g))
        self.tf = TFunction(self.ts, name="f", data=torch.tensor(f))
        self.tg = TFunction(self.ts, name="g", data=torch.tensor(g))


@pytest.fixture(scope="module", params=sorted(SPACES))
def case(request):
    return Case(SPACES[request.param])


#: name -> the operation on (f, g, a, x): Functions f and g, the numpy
#: array a, and x, a as each package's array type
OPERATIONS = {
    "f + g": lambda f, g, a, x: f + g,
    "f + 2.5": lambda f, g, a, x: f + 2.5,
    "2.5 + f": lambda f, g, a, x: 2.5 + f,
    "f + array": lambda f, g, a, x: f + x,
    "array + f": lambda f, g, a, x: x + f,
    "f + numpy": lambda f, g, a, x: f + a,
    "f - g": lambda f, g, a, x: f - g,
    "f - 2.5": lambda f, g, a, x: f - 2.5,
    "2.0 - f": lambda f, g, a, x: 2.0 - f,
    "array - f": lambda f, g, a, x: x - f,
    "f - numpy": lambda f, g, a, x: f - a,
    "f.__rsub__(numpy)": lambda f, g, a, x: f.__rsub__(a),
    "f * g": lambda f, g, a, x: f * g,
    "f * 3.0": lambda f, g, a, x: f * 3.0,
    "3.0 * f": lambda f, g, a, x: 3.0 * f,
    "array * f": lambda f, g, a, x: x * f,
    "f * numpy": lambda f, g, a, x: f * a,
    "f.__rmul__(numpy)": lambda f, g, a, x: f.__rmul__(a),
    "f * numpy scalar": lambda f, g, a, x: f * np.float64(0.75),
    "(f - g) * f": lambda f, g, a, x: (f - g) * f,
    "f.dat.data": lambda f, g, a, x: f.dat.data,
}


@pytest.mark.parametrize("op", sorted(OPERATIONS))
def test_arithmetic_matches_reference(case, op):
    fn = OPERATIONS[op]
    want = fn(case.jf, case.jg, case.a, jnp.asarray(case.a))
    got = fn(case.tf, case.tg, case.a, torch.tensor(case.a))
    close(got, want)


def test_numpy_on_the_left_gives_the_reflected_operator(case):
    """``array op f`` with a numpy array on the left is the reflected
    operator of ``f``, a tensor. The reference's Function lets numpy
    broadcast it as an object, so its ``array - f`` is an object array
    holding one whole field per element (ROADMAP C)."""
    a = case.a
    for got, want in ((a + case.tf, case.jf.__radd__(a)),
                      (a - case.tf, case.jf.__rsub__(a)),
                      (a * case.tf, case.jf.__rmul__(a)),
                      (np.float64(2.0) - case.tf, 2.0 - case.jf)):
        close(got, want)
    ref = a - case.jf
    assert ref.dtype == object and ref.shape == a.shape


def test_getitem_matches_reference(case):
    idx = [0, 1] if case.ts.dim > 1 else [0, 3, slice(2, 5), (1, 2)]
    for i in idx:
        close(case.tf[i], case.jf[i])
    if case.ts.dim > 1:
        assert case.tf[0].shape == case.ts.dof_shape()[:-1]


def test_copy_matches_reference_and_is_not_aliased(case):
    want = case.jf.copy()
    got = case.tf.copy()
    assert isinstance(got, TFunction) and got is not case.tf
    assert got.function_space is case.ts and got.name == want.name == "f"
    close(got.data, want.data)
    before = case.tf.data.clone()
    got.data.add_(1.0)
    got.data[0] = -7.0
    assert torch.equal(case.tf.data, before)
    assert case.tf.copy(deepcopy=False).data.data_ptr() != \
        case.tf.data.data_ptr()


def _field(pkg, dim):
    """A smooth field of the dof coordinates, written with the package's
    own user vocabulary."""
    def scalar(x, y):
        return pkg.sin(x * 2e-3) * y * 1e-3 + pkg.exp(-x * 1e-3)

    if dim == 1:
        return scalar
    return lambda x, y: pkg.as_vector([scalar(x, y), pkg.cos(y * 3e-3)])


def test_project_matches_reference(case):
    """``project`` of a callable, of a dof-shaped array and of a scalar is
    ``interpolate``, as in the reference."""
    for expr_j, expr_t in ((_field(japi, case.ts.dim),
                            _field(tapi, case.ts.dim)),
                           (jnp.asarray(case.a), case.a),
                           (1.25, 1.25)):
        jf = JFunction(case.js).project(expr_j)
        tf = TFunction(case.ts).project(expr_t)
        close(tf.data, jf.data)
        close(tf.data, TFunction(case.ts).interpolate(expr_t).data)


def test_numpy_operand_takes_the_functions_dtype(case):
    """A numpy operand goes to the Function's device and dtype, as
    ``assign``/``interpolate`` take numpy input: an f32 Function with an
    f64 array gives f32."""
    mesh = tgen.RectangleMesh(4, 3, 1e3, 8e2, device="cpu",
                              dtype=torch.float32)
    f32 = TFunction(TFS(mesh, "DG", 1, dim=case.ts.dim),
                    data=case.tf.data.numpy())
    for got in (f32 + case.a, case.a - f32, f32 * case.a,
                f32 - np.float64(1.0)):
        assert got.dtype == torch.float32 and got.device == f32.data.device
    close((f32 * case.a).double(), (case.jf * case.a), rtol=1e-6)
    assert case.tf.dat is case.tf
