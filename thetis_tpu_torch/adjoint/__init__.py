"""The adjoint (port of ``thetis_tpu/adjoint/``): :class:`Control`,
:class:`ReducedFunctional`, :func:`taylor_test` and :func:`minimize` over
``FlowSolver2d.differentiable_forward``; :mod:`.checkpointing` and
:mod:`.inversion_tools`."""
from .reduced_functional import (
    Control,
    ReducedFunctional,
    taylor_test,
    minimize,
)

__all__ = ["Control", "ReducedFunctional", "taylor_test", "minimize"]
