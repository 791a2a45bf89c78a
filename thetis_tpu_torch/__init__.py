"""thetis_tpu_torch: the PyTorch/CUDA port of ``thetis_tpu``.

The package mirrors ``thetis_tpu``'s module tree (``mesh/``, ``fem/``,
``equations/``, ``solvers/``, ``timeintegration/``, ``kernels/``,
``model/``) so each ported function sits at the same path as its JAX
reference.  It imports ``torch`` and never ``jax`` or ``thetis_tpu``.

Conventions:

* The device and dtype are chosen once, at the mesh's constructor
  (``Mesh2d(..., device=, dtype=)``); every space, assembler, equation,
  stepper and solver built on that mesh keeps its tensors there.  There
  is no global default-dtype or default-device switch.
* Host-side mesh preprocessing stays in float64 numpy, as in the reference.
* Solution states are plain dicts with the reference's keys and shapes,
  ``{"uv": (nc, 3, 2), "elev": (nc, 3)}``.
* The reference's ``jit``/``lax`` loops are eager Python loops here.
* Every hand-written CUDA kernel lives in ``csrc/`` and is reached through
  a wrapper in ``kernels/`` that runs the plain PyTorch version for CPU
  tensors and launches the kernel (or raises) for CUDA tensors.

``from thetis_tpu_torch import *`` gives the thetis-style user namespace
of the reference's ``api.py``: the meshes (``Mesh2d``, ``RectangleMesh``,
``SquareMesh``, ``UnitSquareMesh``, ``PeriodicRectangleMesh``), the
spaces (``FunctionSpace``, ``VectorFunctionSpace``, ``get_functionspace``,
``Function``, ``SpatialCoordinate``, ``DGAssembler``), ``Constant``,
``solver2d.FlowSolver2d`` and its options (``ModelOptions2d``,
``TracerFieldOptions``), ``field_metadata``, ``FieldDict``, ``AttrDict``,
the callbacks (``callback``, ``DiagnosticCallback``, ``DetectorsCallback``,
``TimeSeriesCallback2D``, ``TimeSeriesCallback3D``),
``VertexBasedP1DGLimiter``, ``physical_constants``, ``print_output``,
``set_log_directory`` and the math vocabulary of user expressions
(``exp``, ``sqrt``, ``sin``, ``cos``, ``tan``, ``sinh``, ``cosh``,
``tanh``, ``ln``, ``pi``, ``conditional``, ``min_value``, ``max_value``,
``dot``, ``as_vector``; ``abs`` as an attribute) as torch functions that
also take numpy arrays and numbers (in float64).  The mesh constructors
(those of ``thetis_tpu_torch.mesh.generation`` and ``.mesh2d``, which the
facade re-exports, the sphere meshes and the gmsh reader) put the mesh on
the CUDA device, in float64, unless ``device=``/``dtype=`` say otherwise;
without a card they raise unless the caller asks for the CPU with
``device="cpu"``.  Exporters,
checkpoints (``load_state``) and the file-driven forcing
(``thetis_tpu_torch.model.forcing``, ``.forcing_adapters``,
``thetis_tpu_torch.utils.tides``, ``.netcdf_io``) are imported as in the
reference.

The adjoint is ``thetis_tpu_torch.adjoint`` (``Control``,
``ReducedFunctional``, ``taylor_test``, ``minimize``; the inversion
toolkit in ``thetis_tpu_torch.adjoint.inversion_tools``), over
``FlowSolver2d.differentiable_forward``, imported as a script imports
``thetis_tpu.adjoint``.
"""
import numpy as _np
import torch

from . import adjoint
from .config import physical_constants
from .equations.limiter import VertexBasedP1DGLimiter
from .fem.assembly import DGAssembler
from .fem.functionspace import (Function, FunctionSpace, SpatialCoordinate,
                                VectorFunctionSpace, get_functionspace)
from .mesh.generation import (PeriodicRectangleMesh, RectangleMesh,
                              SquareMesh, UnitSquareMesh)
from .mesh.mesh2d import Mesh2d
from .model import callback
from .model import flowsolver2d as solver2d
from .model.callback import (DetectorsCallback, DiagnosticCallback,
                             TimeSeriesCallback2D, TimeSeriesCallback3D)
from .model.field_defs import AttrDict, FieldDict, field_metadata
from .model.flowsolver2d import FlowSolver2d
from .model.options import ModelOptions2d, TracerFieldOptions
from .utils.constant import Constant
from .utils.log import print_output, set_log_directory

__version__ = "0.1.0"

__all__ = ["physical_constants", "Mesh2d", "RectangleMesh",
           "UnitSquareMesh", "PeriodicRectangleMesh", "SquareMesh",
           "FunctionSpace", "VectorFunctionSpace", "Function",
           "SpatialCoordinate", "get_functionspace", "DGAssembler",
           "Constant", "print_output", "set_log_directory",
           "ModelOptions2d", "TracerFieldOptions", "field_metadata",
           "FieldDict", "AttrDict", "solver2d", "FlowSolver2d", "callback",
           "DiagnosticCallback", "DetectorsCallback", "TimeSeriesCallback2D",
           "TimeSeriesCallback3D", "VertexBasedP1DGLimiter", "exp", "sqrt",
           "sin", "cos", "tan", "sinh", "cosh", "tanh", "ln", "pi",
           "conditional", "min_value", "max_value", "dot", "as_vector"]

pi = float(torch.pi)


def _t(x):
    """A tensor as it is; a number or array as a tensor, floats in
    float64 (integers become float64 too, booleans stay)."""
    if isinstance(x, torch.Tensor):
        return x
    a = _np.asarray(x)
    return torch.as_tensor(a.astype(_np.float64) if a.dtype.kind in "iu"
                           else a)


def _unary(fn, name):
    def op(x):
        return fn(_t(x))

    op.__name__ = name
    op.__doc__ = f"``torch.{fn.__name__}`` of a tensor, array or number."
    return op


exp = _unary(torch.exp, "exp")
sqrt = _unary(torch.sqrt, "sqrt")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
ln = _unary(torch.log, "ln")
# mirrors ufl.abs; left out of __all__ as the reference leaves it, so
# that ``import *`` keeps the builtin
abs = _unary(torch.abs, "abs")  # noqa: A001


def conditional(cond, true_val, false_val):
    return torch.where(_t(cond), _t(true_val), _t(false_val))


def min_value(a, b):
    return torch.minimum(_t(a), _t(b))


def max_value(a, b):
    return torch.maximum(_t(a), _t(b))


def dot(a, b):
    return (_t(a) * _t(b)).sum(-1)


def as_vector(components):
    comps = [_t(c) for c in components]
    shape = torch.broadcast_shapes(*[c.shape for c in comps])
    return torch.stack([c.broadcast_to(shape) for c in comps], dim=-1)
