"""Wall-time section profiler (deal.II TimerOutput analog).

Reference: TimerOutput::Scope sections like "Assemble system" / "Solve
linear system" in every solver (e.g. include/mpi_fluid_solver.h:244-245),
with a summary table printed at destruction.  Device work is asynchronous
under JAX, so `scope(...)` optionally blocks on a result to attribute time
correctly.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timer:
    def __init__(self, name: str = "timer"):
        self.name = name
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def scope(self, section: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                try:
                    sync.block_until_ready()
                except AttributeError:
                    pass
            dt = time.perf_counter() - t0
            self.totals[section] += dt
            self.counts[section] += 1

    def summary(self) -> str:
        if not self.totals:
            return f"[{self.name}] no sections recorded"
        total = sum(self.totals.values())
        lines = [f"+---- {self.name} wall times " + "-" * 30,
                 f"| {'section':<32} {'calls':>7} {'total s':>10} {'%':>6}"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"| {k:<32} {self.counts[k]:>7} "
                         f"{self.totals[k]:>10.3f} "
                         f"{100 * self.totals[k] / total:>5.1f}%")
        lines.append("+" + "-" * 58)
        return "\n".join(lines)

    def print_summary(self):
        print(self.summary())


# the tensor methods through which the port reads a device value on the
# host; each waits for the device to finish the work queued before it
_SYNC_METHODS = ("item", "cpu", "tolist", "__bool__", "__float__",
                 "__int__", "__index__")


@contextmanager
def count_host_syncs(counted=lambda t: t.is_cuda):
    """Count the host synchronisations inside the block: the calls of
    item(), cpu(), tolist(), bool(), float() and int() on a tensor that
    `counted` accepts (default: CUDA tensors).  Yields a dict whose
    "syncs" entry is the running count.  The eager Krylov loops end every
    iteration in one such call (la/krylov.py), so this is the number a
    CUDA graph or an on-device stopping test would remove.  float(t) is
    counted once although torch routes it through item()."""
    import torch
    out = {"syncs": 0}
    own = vars(torch.Tensor)
    saved = {name: own.get(name) for name in _SYNC_METHODS}
    depth = [0]

    def wrap(fn):
        def method(self, *args, **kw):
            if depth[0] == 0 and counted(self):
                out["syncs"] += 1
            depth[0] += 1
            try:
                return fn(self, *args, **kw)
            finally:
                depth[0] -= 1
        return method

    for name in saved:
        setattr(torch.Tensor, name, wrap(getattr(torch.Tensor, name)))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            if fn is None:      # inherited: drop the override
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
