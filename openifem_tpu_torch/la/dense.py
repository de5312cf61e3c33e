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
lists: a (n_h, k) row gather, a small weighted index_add_ into the master
rows, and a fixed-row mask.  The masks are applied IN PLACE on the freshly
assembled matrix, so a Newton iteration holds one copy of each block (the
leaflet's f32 A block is 871 MB at full size).  The GEMVs stay
torch.matmul: the JAX package leaves them to XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class HangingTables(NamedTuple):
    """Static hanging-node structure of one Constraints object (the
    runtime-varying Dirichlet set does not touch these)."""
    rows: np.ndarray      # (n_h,) hanging dof ids
    masters: np.ndarray   # (n_h, m) master dof ids
    weights: np.ndarray   # (n_h, m) weights


def hanging_tables(cons) -> Optional[HangingTables]:
    """The static hanging structure of a Constraints object (call on the
    solver's own constraints; extended runtime variants share it)."""
    if not cons.any_hanging:
        return None
    rows = np.where(cons.hanging.cpu().numpy())[0]
    if len(rows) == 0:
        return None
    return HangingTables(rows, cons.hang_idx.cpu().numpy()[rows],
                         cons.hang_w.cpu().numpy()[rows])


def dense_from_elements(blocks, row_dofs, col_dofs, n_rows: int,
                        n_cols: int, dtype=None):
    """Assemble element blocks (n_c, nl_r, nl_c) into a dense
    (n_rows, n_cols) matrix (duplicate dofs accumulate)."""
    if dtype is None:
        dtype = blocks.dtype
    M = torch.zeros((n_rows, n_cols), dtype=dtype, device=blocks.device)
    flat = (row_dofs.long()[:, :, None] * n_cols +
            col_dofs.long()[:, None, :])
    M.view(-1).index_add_(0, flat.reshape(-1),
                          blocks.to(dtype).reshape(-1))
    return M


def _tables(ht: HangingTables, M):
    dev = M.device
    return (torch.as_tensor(ht.rows, device=dev),
            torch.as_tensor(ht.masters, device=dev).reshape(-1),
            torch.as_tensor(ht.weights, dtype=M.dtype, device=dev))


def condense_left(M, fixed, ht: Optional[HangingTables]):
    """R M, in place: accumulate hanging rows into their master rows, then
    zero fixed rows.  Returns M."""
    if ht is not None:
        rows, masters, w = _tables(ht, M)
        Mh = M[rows]                                      # (n_h, k)
        add = w[:, :, None] * Mh[:, None, :]              # (n_h, m, k)
        M.index_add_(0, masters, add.reshape(-1, M.shape[1]))
    return M.masked_fill_(fixed[:, None], 0.0)


def condense_right(M, fixed, ht: Optional[HangingTables]):
    """M E = (R M^T)^T, in place: distribute hanging columns into master
    columns, then zero fixed columns.  Returns M."""
    if ht is not None:
        rows, masters, w = _tables(ht, M)
        Mh = M[:, rows]                                   # (k, n_h)
        add = Mh[:, :, None] * w[None, :, :]              # (k, n_h, m)
        M.index_add_(1, masters, add.reshape(M.shape[0], -1))
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
