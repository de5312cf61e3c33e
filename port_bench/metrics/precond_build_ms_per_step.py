"""Host wall time of the block preconditioner's build per time step, in
ms: the program's "precond_build" spans (InsIM._make_preconditioner once
per Newton iteration: the diagonals, the stencil weights, the Schur
diagonal), inclusive, over a replay of the segment under the program's
tracer alone (spanrun.py), over its steps."""

import spanrun


def read(ctx):
    return spanrun.per_step_ms(ctx, "precond_build")
