"""Ragged and degenerate inputs for the ring matvec and block-Jacobi
kernels (``csrc/ring_mv.cu``, ``csrc/block_diag_mv.cu``) and for the
tridiagonal solve (``csrc/tridiag.cu``), one list each, shared by the CPU
tests (plain versions against the JAX package) and ``chip_smoke.py`` (each
kernel against its plain version on the card).

The cell counts sit around the kernels' 32-cell tile: one cell, one short
of a tile, one over, one short of the 3D step's 4,608, and one over the 2D
CN bench's 102,400 (a tile with one cell, past many full ones).  The ring
tables are random (numpy, seeded): slot 0 is the cell itself, as in
``solvers.assembled.cell_ring``; neighbours are any cells, some repeated
within a row; invalid slots point anywhere; some rows, the last cell's
among them, have no valid slot at all.

The tridiagonal cases put the column count around the tiled kernel's
64-column tile (one column, one short of a tile, one over, one short of
the 3D step's 13,824 and one over its 27,648), for columns of one row, two
rows, the 3D step's 13, an even 14 (a padded tile) and 300 (a tile that
needs more than 48 KB of shared memory in f32 and the general kernel in
f64), with one right-hand side of the coefficients' shape and with two
sharing each coefficient column.
"""
import numpy as np

__all__ = ["RAGGED_NC", "ragged_case", "RAGGED_TRIDIAG",
           "ragged_tridiag_case"]

RAGGED_NC = (1, 31, 33, 4607, 102401)
#: (columns, rows, right-hand sides a column)
RAGGED_TRIDIAG = tuple((bc, n, nrhs)
                       for bc in (1, 63, 65, 13823, 27649)
                       for n in (1, 2, 13, 14, 300)
                       for nrhs in (1, 2))


def ragged_case(nc, seed=0):
    """Float64 numpy inputs of one ragged case: ``blocks_T (4, 9, 9, nc)``
    (random also in the invalid slots, which must be skipped), ``x_T
    (9, nc)``, ``diag_T (9, 9, nc)``, int32 ``ring (nc, 4)`` and bool
    ``valid (nc, 4)``."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(0, nc, size=(nc, 4)).astype(np.int32)
    ring[:, 0] = np.arange(nc)
    valid = rng.random((nc, 4)) < 0.8
    valid[:, 0] = True
    dup = rng.random(nc) < 0.25
    dup[0] = True
    ring[dup, 2] = ring[dup, 1]           # a neighbour counted twice
    valid[dup, 1:3] = True
    valid[0, 3] = False                    # junk to skip, one cell or many
    if nc > 1:
        dead = rng.random(nc) < 0.1
        dead[-1] = True                    # in the last (masked) tile
        valid[dead] = False
    blocks_T = rng.standard_normal((4, 9, 9, nc))
    x_T = rng.standard_normal((9, nc))
    diag_T = rng.standard_normal((9, 9, nc))
    return blocks_T, x_T, diag_T, ring, valid


def ragged_tridiag_case(bc, n, nrhs, seed=0):
    """Float64 numpy operands of one tridiagonal case: diagonally dominant
    ``dl, dd, du (bc, n)`` and ``rhs``, ``(bc, n)`` for one right-hand side
    and ``(nrhs, bc, n)`` for several sharing the coefficients."""
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-1.0, 1.0, size=(bc, n))
    du = rng.uniform(-1.0, 1.0, size=(bc, n))
    dd = 2.0 + np.abs(dl) + np.abs(du) + rng.random((bc, n))
    lead = () if nrhs == 1 else (nrhs,)
    rhs = rng.uniform(-1.0, 1.0, size=lead + (bc, n))
    return dl, dd, du, rhs
