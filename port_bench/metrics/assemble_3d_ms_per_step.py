"""Host wall time of the fluid solver's assembly per time step in the 3-D
cell, in ms: the program's "assemble" spans (InsIM._newton_iter_impl: the
27-point element matrix and rhs, the rhs condensation and the read of the
residual norm), inclusive, over a replay of the segment under the
program's tracer alone (spanrun.py), over its steps."""

import spanrun


def read(ctx):
    return spanrun.per_step_ms(ctx, "assemble")
