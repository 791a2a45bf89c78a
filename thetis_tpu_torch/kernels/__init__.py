"""Hand-written CUDA kernels (sources in ``csrc/``), each with its plain PyTorch version.

Nothing is compiled at import: a kernel is built at its first CUDA launch."""

from .tridiag import tridiag_solve  # noqa: F401  (the reference's re-export)
