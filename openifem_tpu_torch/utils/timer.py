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
