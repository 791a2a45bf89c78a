"""thetis_tpu_torch: the PyTorch/CUDA port of ``thetis_tpu``.

The package mirrors ``thetis_tpu``'s module tree (``mesh/``, ``fem/``,
``equations/``, ``solvers/``, ``timeintegration/``, ``kernels/``) so each
ported function sits at the same path as its JAX reference.  It imports
``torch`` and never ``jax`` or ``thetis_tpu``.

Conventions:

* The device and dtype are chosen once, at the mesh's constructor
  (``Mesh2d(..., device=, dtype=)``); every space, assembler, equation and
  stepper built on that mesh keeps its tensors there.  There is no global
  default-dtype or default-device switch.
* Host-side mesh preprocessing stays in float64 numpy, as in the reference.
* Solution states are plain dicts with the reference's keys and shapes,
  ``{"uv": (nc, 3, 2), "elev": (nc, 3)}``.
* The reference's ``jit``/``lax`` loops are eager Python loops here.
* Every hand-written CUDA kernel lives in ``csrc/`` and is reached through
  a wrapper in ``kernels/`` that runs the plain PyTorch version for CPU
  tensors and launches the kernel (or raises) for CUDA tensors.
"""

__version__ = "0.1.0"
