"""Dense condensed operator blocks for small/medium problems.

Counterpart of openifem_tpu/la/dense.py.  Below ~25k dofs per block the
dense matrix of a preconditioner block fits in device memory and one GEMV
replaces the element gather -> block product -> scatter of a matvec.
These helpers build the exact CONDENSED dense matrix of the constrained
operators used throughout the solvers:

    wrap_operator(apply_A)(x) == where(fixed, x, R A E x)

where E = Constraints.expand (zero Dirichlet, hanging from masters) and
R = Constraints.restrict = E^T, so the condensed dense block is

    M = R_row A E_col + diag(fixed)

The hanging-node structure is mesh-static (runtime constraint extensions
only add Dirichlet rows), so condensation uses static hanging-row index
lists, built once per Constraints object: a (n_h, k) row gather, a small
weighted sum into the master rows (la/operators.py::add_at, planned on
the card), and a fixed-row mask.  The build is la/operators.py::dense_sum.
The masks are applied IN PLACE on the freshly assembled matrix, so a
Newton iteration holds one copy of each block (the leaflet's f32 A block
is 871 MB at full size).  The GEMVs stay
torch.matmul: the JAX package leaves them to XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .operators import add_at, dense_sum


class HangingTables(NamedTuple):
    """Static hanging-node structure of one Constraints object (the
    runtime-varying Dirichlet set does not touch these), on its device."""
    rows: torch.Tensor      # (n_h,) hanging dof ids
    masters: torch.Tensor   # (n_h, m) master dof ids
    weights: torch.Tensor   # (n_h, m) weights


def hanging_tables(cons) -> Optional[HangingTables]:
    """The static hanging structure of a Constraints object (call on the
    solver's own constraints; extended runtime variants share it).  Made
    once per object, so the master table keeps its sum plan."""
    if "_hanging_tables" not in cons.__dict__:
        ht = None
        if cons.any_hanging:
            rows = torch.nonzero(cons.hanging).reshape(-1)
            if len(rows):
                ht = HangingTables(rows, cons.hang_idx[rows],
                                   cons.hang_w[rows])
        cons._hanging_tables = ht
    return cons._hanging_tables


def dense_from_elements(blocks, row_dofs, col_dofs, n_rows: int,
                        n_cols: int, dtype=None):
    """Assemble element blocks (n_c, nl_r, nl_c) into a dense
    (n_rows, n_cols) matrix (duplicate dofs accumulate)."""
    if dtype is None:
        dtype = blocks.dtype
    return dense_sum(blocks.to(dtype), row_dofs, col_dofs, n_rows, n_cols)


def condense_left(M, fixed, ht: Optional[HangingTables]):
    """R M, in place: accumulate hanging rows into their master rows, then
    zero fixed rows.  Returns M."""
    if ht is not None:
        w = ht.weights.to(M.dtype)
        Mh = M[ht.rows]                                   # (n_h, k)
        add = w[:, :, None] * Mh[:, None, :]              # (n_h, m, k)
        add_at(M, ht.masters, add)
    return M.masked_fill_(fixed[:, None], 0.0)


def condense_right(M, fixed, ht: Optional[HangingTables]):
    """M E = (R M^T)^T, in place: distribute hanging columns into master
    columns, then zero fixed columns.  Returns M."""
    if ht is not None:
        w = ht.weights.to(M.dtype)
        Mh = M[:, ht.rows]                                # (k, n_h)
        add = Mh[:, :, None] * w[None, :, :]              # (k, n_h, m)
        add_at(M, ht.masters, add, dim=1)
    return M.masked_fill_(fixed[None, :], 0.0)


def add_unit_diag(M, mask):
    """M + diag(mask), in place.  Returns M."""
    M.diagonal().add_(mask.to(M.dtype))
    return M


def condensed_dense(blocks, row_dofs, col_dofs, n_rows: int, n_cols: int,
                    rcons, ccons, rht: Optional[HangingTables],
                    cht: Optional[HangingTables],
                    unit_fixed_diag: bool = False, dtype=None):
    """Dense condensed operator R A E (+ optional identity on fixed rows,
    making `M @ x` match `cons.wrap_operator(apply_A)(x)` for the square
    case).  rht/cht: static hanging tables of rcons/ccons."""
    M = dense_from_elements(blocks, row_dofs, col_dofs, n_rows, n_cols,
                            dtype)
    M = condense_right(condense_left(M, rcons.fixed, rht), ccons.fixed, cht)
    if unit_fixed_diag:
        assert n_rows == n_cols
        M = add_unit_diag(M, rcons.fixed)
    return M


def gemv(M, x):
    """Dense matvec preserving x's dtype; M may be lower precision (a bf16
    M is multiplied in bf16, as in the JAX package)."""
    return (M @ x.to(M.dtype)).to(x.dtype)
