"""Constraint handling (Dirichlet + hanging nodes) for global dof vectors.

Counterpart of openifem_tpu/la/constraints.py: constraints are dense
(n_dofs, K) gather tables plus masks, held as tensors on one device.
Semantics mirror deal.II's distribute_local_to_global + distribute
(reference: source/insim.cpp:322-332, source/fluid_solver.cpp:66-163):
constrained rows/cols are condensed out of the operator, the Krylov system
keeps identity rows there, and `distribute` writes the constrained values
back into the solution vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import device as _device
from ..config import real_dtype
from .operators import index_sum


class Constraints:
    def __init__(self, n_dofs: int, hang_idx=None, hang_w=None,
                 hanging_mask=None, dirichlet_mask=None,
                 dirichlet_values=None, device=None):
        dev = _device(device)
        rdt = real_dtype()
        self.n_dofs = n_dofs
        if hang_idx is None:
            hang_idx = np.arange(n_dofs)[:, None]
            hang_w = np.ones((n_dofs, 1))
            hanging_mask = np.zeros(n_dofs, dtype=bool)
        if dirichlet_mask is None:
            dirichlet_mask = np.zeros(n_dofs, dtype=bool)
        if dirichlet_values is None:
            dirichlet_values = np.zeros(n_dofs)
        self.hang_idx = torch.as_tensor(np.asarray(hang_idx),
                                        dtype=torch.int64, device=dev)
        self.hang_w = torch.as_tensor(np.asarray(hang_w), dtype=rdt,
                                      device=dev)
        self.hanging = torch.as_tensor(np.asarray(hanging_mask),
                                       dtype=torch.bool, device=dev)
        self.dirichlet = torch.as_tensor(np.asarray(dirichlet_mask),
                                         dtype=torch.bool, device=dev)
        self.dirichlet_values = torch.as_tensor(
            np.asarray(dirichlet_values), dtype=rdt, device=dev)
        self.fixed = self.dirichlet | self.hanging
        self.any_hanging = bool(np.any(np.asarray(hanging_mask)))

    def _from_masters(self, x):
        w = self.hang_w.to(x.dtype)
        xm = (x[self.hang_idx] * w).sum(dim=1)
        return torch.where(self.hanging, xm, x)

    # -- solution-space maps ------------------------------------------
    def distribute(self, x):
        """Set Dirichlet dofs to their BC values, then hanging dofs from
        masters (deal.II AffineConstraints::distribute)."""
        x = torch.where(self.dirichlet, self.dirichlet_values, x)
        return self._from_masters(x) if self.any_hanging else x

    def set_zero(self, x):
        """Zero all constrained dofs."""
        return torch.where(self.fixed, 0.0, x)

    def apply_increment(self, x):
        """deal.II Newton-constraint semantics: the inhomogeneity is ADDED
        to the evaluation point at the first Newton iteration (reference:
        source/insim.cpp:409-449)."""
        x = torch.where(self.dirichlet, x + self.dirichlet_values, x)
        return self._from_masters(x) if self.any_hanging else x

    def apply_increment_with(self, x, values):
        """apply_increment with caller-supplied inhomogeneities (the
        steppers feed per-step hard-coded BC tables)."""
        x = torch.where(self.dirichlet, x + values, x)
        return self._from_masters(x) if self.any_hanging else x

    def distribute_with_values(self, x, dirichlet_values):
        """distribute() with caller-supplied Dirichlet values."""
        x = torch.where(self.dirichlet, dirichlet_values, x)
        return self._from_masters(x) if self.any_hanging else x

    def expand(self, x):
        """Homogeneous prolongation P x: hanging dofs from masters,
        Dirichlet dofs zeroed.  Dtype-preserving."""
        x = torch.where(self.dirichlet, 0.0, x)
        return self._from_masters(x) if self.any_hanging else x

    def restrict(self, y):
        """P^T y: accumulate hanging rows into masters, zero constrained.
        Dtype-preserving."""
        if self.any_hanging:
            w = self.hang_w.to(y.dtype)
            contrib = torch.where(self.hanging, y, 0.0)
            add = index_sum(y.shape[0], self.hang_idx, contrib[:, None] * w)
            y = y + add
        return torch.where(self.fixed, 0.0, y)

    # -- operator / rhs wrappers --------------------------------------
    def wrap_operator(self, apply_A):
        """Condensed operator: identity on constrained dofs."""
        def op(x):
            y = self.restrict(apply_A(self.expand(x)))
            return torch.where(self.fixed, x, y)
        return op

    def condense_rhs(self, r):
        r = self.restrict(r)
        return torch.where(self.fixed, 0.0, r)

    def with_extra_dirichlet(self, mask, values):
        """New Constraints with additional Dirichlet rows merged in; existing
        constraints win (deal.II MergeConflictBehavior::left_object_wins,
        reference: source/fsi.cpp:297-305)."""
        add = mask & ~self.fixed
        new = Constraints.__new__(Constraints)
        new.n_dofs = self.n_dofs
        new.any_hanging = self.any_hanging
        new.hang_idx = self.hang_idx
        new.hang_w = self.hang_w
        new.hanging = self.hanging
        new.dirichlet = self.dirichlet | add
        new.dirichlet_values = torch.where(add, values,
                                           self.dirichlet_values)
        new.fixed = self.fixed | add
        return new

    def with_dirichlet(self, mask, values):
        """New Constraints with the same hanging tables and the given
        Dirichlet rows (device tensors), replacing this set's: built on
        the device, with no host copy."""
        new = Constraints.__new__(Constraints)
        new.n_dofs = self.n_dofs
        new.any_hanging = self.any_hanging
        new.hang_idx = self.hang_idx
        new.hang_w = self.hang_w
        new.hanging = self.hanging
        new.dirichlet = mask
        new.dirichlet_values = values
        new.fixed = mask | self.hanging
        return new
