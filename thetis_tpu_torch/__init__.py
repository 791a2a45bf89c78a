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

``from thetis_tpu_torch import *`` gives the part of the thetis-style user
namespace that the 2D model needs (``solver2d.FlowSolver2d``,
``RectangleMesh``, ``SquareMesh``, ``UnitSquareMesh``,
``PeriodicRectangleMesh``, ``FunctionSpace``, ``Function``,
``SpatialCoordinate``, ``Constant``, ``TracerFieldOptions``,
``VertexBasedP1DGLimiter``, ``physical_constants``, ``exp``), so
``demos/demo_2d_channel.py``, ``demos/demo_2d_tracer.py`` and the
sediment-trench, tidal-array and solitary-wave examples run with their
import lines changed (the farm options and ``TurbineFunctionalCallback``
from ``thetis_tpu_torch.model.turbines``).  The facade's mesh generators put the mesh on the
CUDA device, in float64, unless ``device=``/``dtype=`` say otherwise;
without a card they raise unless the caller asks for the CPU with
``device="cpu"``; so do the sphere meshes and the gmsh reader, which a
script imports from ``thetis_tpu_torch.mesh.sphere`` and
``thetis_tpu_torch.mesh.gmsh`` as it does from the reference.  The rest
of the reference's ``api.py`` waits for ROADMAP A10.

The adjoint is ``thetis_tpu_torch.adjoint`` (``Control``,
``ReducedFunctional``, ``taylor_test``, ``minimize``; the inversion
toolkit in ``thetis_tpu_torch.adjoint.inversion_tools``), over
``FlowSolver2d.differentiable_forward``, imported as a script imports
``thetis_tpu.adjoint``.
"""
import torch

from . import adjoint
from .config import physical_constants
from .equations.limiter import VertexBasedP1DGLimiter
from .fem.functionspace import Function, FunctionSpace, SpatialCoordinate
from .mesh import generation as _generation
from .mesh.mesh2d import default_device
from .model import flowsolver2d as solver2d
from .model.flowsolver2d import FlowSolver2d
from .model.options import TracerFieldOptions
from .utils.constant import Constant
from .utils.log import print_output

__version__ = "0.1.0"

__all__ = ["solver2d", "FlowSolver2d", "RectangleMesh", "SquareMesh",
           "UnitSquareMesh", "PeriodicRectangleMesh", "FunctionSpace",
           "Function", "SpatialCoordinate", "Constant", "TracerFieldOptions",
           "VertexBasedP1DGLimiter", "physical_constants", "print_output",
           "exp", "pi"]

exp = torch.exp
pi = float(torch.pi)


def RectangleMesh(nx, ny, lx, ly, originX=0.0, originY=0.0,
                  name="rectangle", *, device=None, dtype=torch.float64):
    """:func:`thetis_tpu_torch.mesh.generation.RectangleMesh` with the
    facade's default device and dtype."""
    return _generation.RectangleMesh(nx, ny, lx, ly, originX, originY, name,
                                     device=default_device(device),
                                     dtype=dtype)


def PeriodicRectangleMesh(nx, ny, lx, ly, direction="x",
                          name="periodic_rectangle", *, device=None,
                          dtype=torch.float64):
    """:func:`thetis_tpu_torch.mesh.generation.PeriodicRectangleMesh` with
    the facade's default device and dtype."""
    return _generation.PeriodicRectangleMesh(
        nx, ny, lx, ly, direction, name, device=default_device(device),
        dtype=dtype)


def SquareMesh(nx, ny, l, name="square", *, device=None,
               dtype=torch.float64):
    """:func:`thetis_tpu_torch.mesh.generation.SquareMesh` with the
    facade's default device and dtype."""
    return _generation.SquareMesh(nx, ny, l, name,
                                  device=default_device(device),
                                  dtype=dtype)


def UnitSquareMesh(nx, ny, name="unitsquare", *, device=None,
                   dtype=torch.float64):
    """:func:`thetis_tpu_torch.mesh.generation.UnitSquareMesh` with the
    facade's default device and dtype."""
    return _generation.UnitSquareMesh(nx, ny, name,
                                      device=default_device(device),
                                      dtype=dtype)
