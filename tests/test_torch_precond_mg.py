"""One application of the block-Schur preconditioner, per branch of
InsIM._make_preconditioner, in the port and in the JAX package: the same
mesh, knobs, Newton matrix (each package assembles it at the same seeded
state) and input vector.  This file: the branches on the
uniform channel of the r2 case (h = 0.2, two levels): the stencil patch
layout, the pressure V-cycle (geometric, as FSI.run attaches it, and
Galerkin) preconditioning the Schur CG, the V-cycle as Sm^-1
(mg_direct), and the velocity V-cycle (Galerkin, preconditioning the
A-solve; geometric, two cycles as the A-solve with mg_direct; Galerkin
with a_mg_precond).

At the default inner tolerances (Mp / Sm CG to 1e-6, A-solve to 1e-3)
one apply is sensitive to rounding in the reference itself: perturbing the
input by 1e-15 (relative) moves the JAX package's output by 2.8e-8 and
its Schur CG count by one (stencil and block-Jacobi branches on these
meshes).  So the f64 check runs the inner solves to convergence
(mp_sm_rtol 1e-13, a_inner_rtol 1e-12), where one apply is the
preconditioner's linear map: every branch agrees to 1e-10, relative to
the reference's max norm, with inner iteration counts within one of each
other (a converged solve may stop one iteration apart).

The bench knob set runs the preconditioner in float32.  Its inner
solves stop at loose tolerances (mp_sm_rtol 1e-1, a_inner_rtol 1e-2), and
float32 sums in another order move a Krylov iterate by about its own
rounding, so that apply is held to 1e-3.
"""

import pytest

from torch_parity import TIGHT, precond_check, R2_SMALL, mg_enabler

CASES = {
    "stencil": (R2_SMALL, dict(mg_direct=False), None, "stencil", "cg"),
    "pressure_mg": (R2_SMALL, dict(mg_direct=False), mg_enabler("pressure"),
                    "stencil", "cg+vcycle"),
    "pressure_mg_galerkin": (R2_SMALL, dict(mg_direct=False),
                             mg_enabler("pressure_galerkin"), "stencil",
                             "cg+vcycle"),
    "mg_direct": (R2_SMALL, {}, mg_enabler("pressure"), "stencil",
                  "vcycle"),
    "velocity_mg": (R2_SMALL, dict(mg_direct=False), mg_enabler("velocity"),
                    "velocity_mg", "cg"),
    "velocity_mg_direct": (R2_SMALL, dict(a_mg_cycles=2),
                           mg_enabler("velocity_geo"), "velocity_mg", "cg"),
    "a_mg_precond": (R2_SMALL, dict(a_mg_precond=True),
                     mg_enabler("velocity"), "velocity_mg", "cg"),
}
BENCH = (dict(R2_SMALL, bench_precision=True), {}, mg_enabler("pressure"),
         "stencil", "vcycle")
BENCH_TOL = 1e-3


@pytest.mark.parametrize("name", CASES)
def test_precond_apply_f64(name):
    case_kw, knobs, *branch = CASES[name]
    err, jits, pits = precond_check(case_kw, dict(TIGHT, **knobs), *branch)
    assert all(abs(a - b) <= 1 for a, b in zip(pits, jits)), (pits, jits)
    assert err <= 1e-10, err


def test_precond_apply_bench_knobs():
    err, _, _ = precond_check(*BENCH)
    assert err <= BENCH_TOL, err
