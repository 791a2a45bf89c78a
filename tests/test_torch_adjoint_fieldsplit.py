"""The assembled semi-implicit CN's gradient under the Schur fieldsplit
preconditioner (``SchurFieldsplitPC.transpose`` in the ring solve's
adjoint) against ``jax.grad`` of the reference's: the port's counterpart
of the reference's ``slow`` ``test_assembled_pc.py::
test_fieldsplit_cn_step_and_gradient``, on ``test_torch_flowsolver2d``'s
12x6 rectangle at a wave CFL of 25, one step, with respect to the drag
field and the initial elevation, f64, CPU, 1e-10 of the largest entry
(see ``test_torch_adjoint_assembled.py``)."""
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

from test_torch_adjoint_assembled import (  # noqa: E402
    check_assembled_cn_gradient)
from test_torch_flowsolver2d import one_torch_thread  # noqa: E402,F401


def test_assembled_cn_schur_gradient_matches_reference(monkeypatch):
    check_assembled_cn_gradient("cn_schur", monkeypatch)
