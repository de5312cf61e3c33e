"""Host wall time of the preconditioner's inner A-solves per time step in
the 3-D cell, in ms: the program's "inner_a" spans (the 3-D stencil FGMRES
of each preconditioner apply), inclusive, over a replay of the segment
under the program's tracer alone (spanrun.py), over its steps."""

import spanrun


def read(ctx):
    return spanrun.per_step_ms(ctx, "inner_a")
