"""Global configuration for thetis_tpu_torch.

Precision policy: host-side mesh/tabulation preprocessing is float64
numpy; device tensors take the dtype given to the mesh constructor (see
``mesh/mesh2d.py``).  Unlike the reference (``thetis_tpu/config.py``),
nothing here follows a global precision switch.

Reference parity: physical constants mirror
``thetis/physical_constants.py:6-14`` in the reference implementation.
"""

import os

__all__ = ["physical_constants", "BUILD_DIR"]

#: Where the package compiles its native code at first use: the CUDA
#: kernels (``kernels/build.py``) and the host mesh builder
#: (``native/``).  Listed in ``.gitignore``.
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")

#: Physical constants (mutable at runtime, like the reference's Constant
#: dict).  Plain Python floats: they enter tensor expressions as scalars
#: and so take each tensor's own dtype.
physical_constants = {
    "g_grav": 9.81,
    "rho0": 1000.0,
    "von_karman": 0.4,
    "rho_air": 1.22,
}
