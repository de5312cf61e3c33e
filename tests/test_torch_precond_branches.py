"""One application of the block-Schur preconditioner, per branch of
InsIM._make_preconditioner, in the port and in the JAX package: the same
mesh, knobs, Newton matrix (each package assembles it at the same seeded
state) and input vector.  This file: the branches on the
locally refined leaflet mesh (h = 0.1): dense condensed operators, nodal
block-Jacobi, a_poly = 3 and the stencil inside the constraint wrap.

At the default inner tolerances (Mp / Sm CG to 1e-6, A-solve to 1e-3)
one apply is sensitive to rounding in the reference itself: perturbing the
input by 1e-15 (relative) moves the JAX package's output by 2.8e-8 and
its Schur CG count by one (stencil and block-Jacobi branches on these
meshes).  So the f64 check runs the inner solves to convergence
(mp_sm_rtol 1e-13, a_inner_rtol 1e-12), where one apply is the
preconditioner's linear map: every branch agrees to 1e-10, relative to
the reference's max norm, with inner iteration counts within one of each
other (a converged solve may stop one iteration apart).

The bench knob set runs the preconditioner in float32 and the dense A block in bf16.  Its inner
solves stop at loose tolerances (mp_sm_rtol 1e-1, a_inner_rtol 1e-2), and
float32 and bf16 sums in another order move a Krylov iterate by about its own
rounding, so that apply is held to 2e-2 (bf16 keeps 8 significant bits).
"""

import pytest

from torch_parity import TIGHT, precond_check

CASES = {
    "dense": (dict(config="fsi_leaflet"), {}, None, "dense", "cg"),
    "block_jacobi": (dict(), dict(a_block_jacobi=True), None, "element",
                     "cg"),
    "a_poly3": (dict(), dict(a_poly=3), None, "element", "cg"),
    "stencil_flat": (dict(), dict(a_stencil=True, a_poly=2), None,
                     "stencil_flat", "cg"),
}
BENCH = (dict(config="fsi_leaflet", bench_precision=True), {}, None,
         "dense", "cg")
BENCH_TOL = 2e-2


@pytest.mark.parametrize("name", CASES)
def test_precond_apply_f64(name):
    case_kw, knobs, *branch = CASES[name]
    err, jits, pits = precond_check(case_kw, dict(TIGHT, **knobs), *branch)
    assert all(abs(a - b) <= 1 for a, b in zip(pits, jits)), (pits, jits)
    assert err <= 1e-10, err


def test_precond_apply_bench_knobs():
    err, _, _ = precond_check(*BENCH)
    assert err <= BENCH_TOL, err
