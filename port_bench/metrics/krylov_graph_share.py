"""Share of the preconditioner's inner Krylov iterations that ran inside
replayed CUDA graphs, in %: the program's counters "krylov.graph_iters"
(iterations of the replayed iteration blocks, la/krylov.py) over those
and "krylov.eager_iters" (iterations of the eager loops in the solves
that can take blocks), over a replay of the segment under the program's
tracer alone (spanrun.py).  A program without the counters gives None."""

import spanrun


def read(ctx):
    out = spanrun.context(ctx)
    if out is None:
        return None
    counts = out.get("sync_counts") or {}
    graphs = counts.get("krylov.graph_iters", 0)
    total = graphs + counts.get("krylov.eager_iters", 0)
    return 100.0 * graphs / total if total else None
