"""Whole runs on the CPU (the look for a chip skipped) with the timed path
broken underneath: each fault a cell can have makes `correct` false.  One
card, no batch: the faults are a step that returns its state unchanged
(the fluid's; the leaflet's solid's) and an answer altered where it is
produced (the fluid's pressure, by one part in 10^4)."""

from __future__ import annotations

import pytest

from conftest import run_cell

UNCHANGED = """
from openifem_tpu_torch.solvers.fluid.insim import InsIM
InsIM._newton_loop = lambda self, eval_pt, present, *a, **k: (present, 0.0, 1)
"""

ALTERED = """
from openifem_tpu_torch.solvers.fluid.insim import InsIM
_real = InsIM._newton_loop
def _altered(self, *a, **k):
    x, rel, it = _real(self, *a, **k)
    x = x.clone()
    x[self.n_u:] *= 1.0 + 1e-4
    return x, rel, it
InsIM._newton_loop = _altered
"""

SOLID_UNCHANGED = """
from openifem_tpu_torch.solvers.solid.hyper import HyperElasticity
HyperElasticity._device_step_impl = (
    lambda self, d, v, a, trhs: (d, v, a, 1))
"""

FAULTS = [("cylinder_tiny", UNCHANGED), ("cylinder_tiny", ALTERED),
          ("cylinder_mg_tiny", UNCHANGED), ("cylinder_mg_tiny", ALTERED),
          ("leaflet_tiny", UNCHANGED), ("leaflet_tiny", ALTERED),
          ("leaflet_tiny", SOLID_UNCHANGED)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=["cyl-unchanged", "cyl-altered",
                              "cyl-mg-unchanged", "cyl-mg-altered",
                              "leaf-unchanged", "leaf-altered",
                              "leaf-solid-unchanged"])
def test_pb_fault_is_not_correct(tree, workload, fault):
    rc, out, err = run_cell(tree, workload, prelude=fault)
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]
