"""Wall-time section profiler (deal.II TimerOutput analog) and the port's
tracer.

Reference: TimerOutput::Scope sections like "Assemble system" / "Solve
linear system" in every solver (e.g. include/mpi_fluid_solver.h:244-245),
with a summary table printed at destruction.  Device work is asynchronous
under JAX, so `scope(...)` optionally blocks on a result to attribute time
correctly.

The tracer: `span(name)` and `count(name)` at the layer boundaries of the
port's paths record into memory while `recording()` is on, and do nothing
otherwise (off by default; then a span is one flag test and the shared
nullcontext, with no allocation, no device work and no host read).  Span
times are time.perf_counter_ns() plus one offset to time.time_ns() taken
when the recording starts: the clock torch.profiler stamps its host and
device events with (ns since the epoch), so spans and a profiled run's
kernels lie on one time line.  `host_read(site)` is the span ("sync")
around a read of a device value on the host, counted under "sync.<site>";
every such read on the fluid stepper's path has one.  Counters besides:
"krylov.graph_iters", "krylov.eager_iters" and "krylov.graph_captures"
(la/krylov.py BlockGraphs).  Span names: set-up
"mesh", "setup", "pressure_mg", "kernel_load", "plan_build",
"first_step"; the stepper's "step", "newton" (children "assemble",
"precond_build", "outer_fgmres"), "inner_mp", "inner_sm", "inner_a" and
"sync"; a coupler's step_span names ("coupling", "solid RK4", "fluid
Newton", ...).
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from typing import NamedTuple


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


class SpanRecord(NamedTuple):
    """One span: its times on the profiler's clock, the index of the span
    it opened in (-1: none) and its step (the number of "step" spans
    opened before it, less one: -1 before the first step)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int


class Recording:
    """What the program recorded while `recording()` was on: `spans`
    (SpanRecord, in the order they opened) and `counts`."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.counts = Counter()
        self.step = -1
        self._raw = []      # [name, start, end, parent, step], perf ns
        self._open = []     # indices of the open spans, innermost last

    @property
    def spans(self):
        off = self.offset_ns
        return [SpanRecord(n, s + off, e + off, p, k)
                for n, s, e, p, k in self._raw]

    def totals(self):
        """{name: (spans, inclusive ns, self ns)}: inclusive counts only
        the spans with no enclosing span of their own name, so that a
        name nested in itself is not counted twice; self leaves out the
        time of the span's children."""
        raw = self._raw
        child = [0] * len(raw)
        out = defaultdict(lambda: [0, 0, 0])
        for _, s, e, p, _ in raw:
            if p >= 0:
                child[p] += e - s
        for i, (name, s, e, p, _) in enumerate(raw):
            t = out[name]
            t[0] += 1
            t[2] += e - s - child[i]
            while p >= 0 and raw[p][0] != name:
                p = raw[p][3]
            if p < 0:
                t[1] += e - s
        return {k: tuple(v) for k, v in out.items()}

    def summary(self, per: int = 1) -> str:
        """A table of totals(), in ms divided by `per` (e.g. the steps)."""
        lines = [f"{'span':<16} {'calls':>8} {'inclusive ms':>13} "
                 f"{'self ms':>10}"]
        for name, (n, inc, own) in sorted(self.totals().items(),
                                          key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<16} {n / per:>8.1f} "
                         f"{inc * 1e-6 / per:>13.3f} "
                         f"{own * 1e-6 / per:>10.3f}")
        for name, n in sorted(self.counts.items()):
            lines.append(f"{name:<16} {n / per:>8.1f}")
        return "\n".join(lines)


class _Span:
    __slots__ = ("rec", "name")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if self.name == "step":
            rec.step += 1
        rec._open.append(len(rec._raw))
        rec._raw.append([self.name, time.perf_counter_ns(), 0,
                         rec._open[-2] if len(rec._open) > 1 else -1,
                         rec.step])

    def __exit__(self, *exc):
        rec = self.rec
        rec._raw[rec._open.pop()][2] = time.perf_counter_ns()
        return False


_NULL = nullcontext()
_REC = None     # the Recording in progress, or None: tracing off


def span(name: str):
    """A context manager that records a span `name` while recording; the
    shared nullcontext otherwise."""
    if _REC is None:
        return _NULL
    return _Span(_REC, name)


def count(name: str, n: int = 1):
    """Add n to the counter `name` while recording."""
    if _REC is not None:
        _REC.counts[name] += n


def host_read(site: str):
    """span("sync") around one read of a device value on the host (it
    waits for the work queued before it), counted under "sync.<site>"."""
    if _REC is None:
        return _NULL
    _REC.counts["sync." + site] += 1
    return _Span(_REC, "sync")


@contextmanager
def recording():
    """Turn tracing on inside the block; yields the Recording."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already on")
    _REC = rec = Recording()
    try:
        yield rec
    finally:
        _REC = None


class DeviceSpans:
    """Named spans timed with CUDA events, for a span hook such as
    MPIFSI.step_span: `with spans("name"): ...` records an event pair on
    the current stream without synchronising; ms() waits for the device
    and returns the summed milliseconds per name, then forgets them."""

    def __init__(self):
        self._events = defaultdict(list)

    @contextmanager
    def __call__(self, name: str):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events[name].append((start, end))

    def ms(self) -> dict:
        import torch
        torch.cuda.synchronize()
        out = {name: sum(a.elapsed_time(b) for a, b in pairs)
               for name, pairs in self._events.items()}
        self._events.clear()
        return out


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
    iteration in one such call, the iteration blocks of la/krylov.py every
    block.  float(t) is counted once although torch routes it through
    item()."""
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
