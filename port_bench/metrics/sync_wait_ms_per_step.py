"""Time the host sits blocked on the device per time step, in ms: the
program's "sync" spans (utils/timer.py host_read, around every read of a
device value on the stepper's path: the Krylov loop tests, norms and
Hessenberg columns, the outer and Newton residual norms), summed over a
replay of the segment under the program's tracer alone (spanrun.py),
over its steps.  Each span holds the read alone: the kernels that compute
the value read are queued before it opens."""

import spanrun


def read(ctx):
    return spanrun.per_step_ms(ctx, "sync")
