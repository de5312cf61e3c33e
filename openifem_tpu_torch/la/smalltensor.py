"""Closed-form determinant/inverse for batched 1x1, 2x2 and 3x3 matrices.

For the (n_cells, n_q) batches of tiny Jacobians the closed forms are
cheaper than a batched LU and give the same arithmetic as the JAX package
(openifem_tpu/la/smalltensor.py).
"""

from __future__ import annotations

import torch


def det(A):
    """Determinant of (..., d, d) for d in {1, 2, 3}."""
    d = A.shape[-1]
    if d == 1:
        return A[..., 0, 0]
    if d == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if d == 3:
        return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] -
                                A[..., 1, 2] * A[..., 2, 1]) -
                A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] -
                                A[..., 1, 2] * A[..., 2, 0]) +
                A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] -
                                A[..., 1, 1] * A[..., 2, 0]))
    raise NotImplementedError(f"det for d={d}")


def inv(A):
    """Inverse of (..., d, d) for d in {1, 2, 3}."""
    d = A.shape[-1]
    detA = det(A)
    if d == 1:
        return 1.0 / A
    if d == 2:
        row0 = torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1)
        row1 = torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1)
        adj = torch.stack([row0, row1], dim=-2)
        return adj / detA[..., None, None]
    if d == 3:
        c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
        c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
        c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
        c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
        c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
        c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
        c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
        c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
        c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        adj = torch.stack([
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ], dim=-2)
        return adj / detA[..., None, None]
    raise NotImplementedError(f"inv for d={d}")
