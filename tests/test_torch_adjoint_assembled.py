"""The assembled semi-implicit CN's gradient (the ring solve's
implicit-function adjoint: ``A^T lam = xbar`` by FGMRES on the ring
matvec of the transposed blocks, under the transposed preconditioner)
through ``FlowSolver2d.differentiable_forward`` of ``thetis_tpu_torch``
against ``jax.grad`` of ``thetis_tpu``'s, f64, CPU: one step on
``test_torch_flowsolver2d``'s 12x6 rectangle with respect to the drag
field and the initial elevation, under the two-level coarse correction
and under the Schur fieldsplit (the port's counterpart of the reference's
``slow`` ``test_assembled_pc.py::test_fieldsplit_cn_step_and_gradient``).

The coarse case runs both packages on the reference's coarse space (one
coarse dof per aggregate and packed component, patched into the port's
solver) at a wave CFL of 4.5, where that space converges; the port's
own per-field space is held by its Taylor rate in
``test_torch_adjoint_swe.py``.  Both packages solve to 1e-10 on the same
Krylov path: the gradients agree to 1e-10 of their largest entry.  The
Schur case is ``test_torch_adjoint_fieldsplit.py`` (each reference
gradient compiles for about a minute: one file each keeps a file's
time near that)."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_mesh_builders import pin_mesh_builders  # noqa: E402

pin_mesh_builders()

import thetis_tpu_torch.solvers.assembled as tas  # noqa: E402
from thetis_tpu_torch.interop import flowsolver2d_from_reference  # noqa: E402
from test_torch_adjoint_swe import (  # noqa: E402
    agree, gradients, u_integral_elev_l2)
from test_torch_flowsolver2d import (  # noqa: E402
    C0, HMIN, one_torch_thread, meshes, reference_solver)

PARAMS = dict(ksp_rtol=1e-10, ksp_max_it=400, gmres_restart=40)


class PerDofCoarse(tas.CoarseCorrection):
    """The reference's coarse space whatever the solver asks for."""

    def __init__(self, blocks, ring, mesh, target_size=None, fields=None):
        super().__init__(blocks, ring, mesh, target_size=target_size)


def check_assembled_cn_gradient(config, monkeypatch):
    jm, tm = meshes("rect")
    dt = 9.0 * HMIN / C0 if config == "cn_coarse" else None
    ref = reference_solver(jm, "rect", config, dt=dt, params=PARAMS)
    if config == "cn_coarse":
        monkeypatch.setattr(tas, "CoarseCorrection", PerDofCoarse)
    port = flowsolver2d_from_reference(ref, tm)
    want = {"cn_coarse": "CoarseCorrection",
            "cn_schur": "SchurFieldsplitPC"}[config]
    assert type(ref.timestepper.coarse).__name__ == want
    assert want in [c.__name__ for c in
                    type(port.timestepper.coarse).__mro__]
    rng = np.random.RandomState(3)
    c = 2.5e-3 * (1.0 + rng.rand(jm.nv))
    e0 = np.asarray(ref.fields.elev_2d.data)
    tp, jp, _ = gradients(ref, port, ["quadratic_drag_coefficient",
                                      "initial_elev"],
                          u_integral_elev_l2, 1, [c, e0])
    agree(tp, jp)
    st = port.timestepper.stats
    assert st["ksp_rel_residual"] < 1e-8
    assert st["adjoint_ksp_cycles"] >= 1


def test_assembled_cn_coarse_gradient_matches_reference(monkeypatch):
    check_assembled_cn_gradient("cn_coarse", monkeypatch)
