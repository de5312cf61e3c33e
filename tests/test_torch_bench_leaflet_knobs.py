"""The two leaflet bench configurations with the JAX bench's full knob set
(bench.py:502-533: f32 preconditioner, f32 Jacobian and outer Krylov
shell, inexact-Newton forcing, loose inner tolerances, the dense A block
in bf16): 3 steps through FSI.run in both packages, at the sizes of
test_torch_bench_leaflet.py and test_torch_bench_leaflet_r2.py.  Newton
counts are equal in every step.  The states agree to 1e-3 (relative to
the reference's max norm): with newton_forcing (1e-4, 0.5) each Newton
system is solved only to 1e-4 of its residual, the Newton loop stops at
1e-6, and float32 / bf16 inner solves that stop at 1e-1 to 1e-2 take the
two packages to different iterates inside those tolerances (measured on
the CPU: 5.3e-5 for fsi_leaflet, 1.4e-5 for fsi_leaflet_r2)."""

import pytest

from torch_parity import rel_err, run_pair

CONFIGS = {
    "fsi_leaflet": (dict(config="fsi_leaflet"), ("dense", "cg")),
    "fsi_leaflet_r2": (dict(config="fsi_leaflet_r2", h=0.2, extra_refine=1),
                       ("stencil", "vcycle")),
}


@pytest.mark.parametrize("name", CONFIGS)
def test_bench_knobs_match_jax(name):
    kw, branch = CONFIGS[name]
    (jfsi, jlog), (pfsi, plog) = run_pair(bench_precision=True, **kw)
    assert len(plog) == 3 and plog == jlog
    assert set(pfsi.fluid.precond_branches) == {branch}
    assert pfsi.fluid.mixed_precision_precond and pfsi.fluid.f32_outer
    errs = [rel_err(a, b) for a, b in (
        (pfsi.fluid.present_solution, jfsi.fluid.present_solution),
        (pfsi.solid.current_displacement, jfsi.solid.current_displacement))]
    assert max(errs) <= 1e-3, errs
