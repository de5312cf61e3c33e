"""Preconditioned CG and flexible GMRES as eager loops.

Counterpart of openifem_tpu/la/krylov.py (reference: PETSc KSP / deal.II
SolverCG / SolverFGMRES, e.g. source/insim.cpp:337-367).  Each
lax.while_loop of the JAX package is a Python loop here with the SAME
stopping tests, evaluated in the working dtype, so the iteration counts
match the JAX package's.  Convergence tests use absolute tolerances
supplied by the caller, as the reference does (tol = c * ||rhs||).

FGMRES uses CGS2 orthogonalization (two classical Gram-Schmidt passes) on
the device.  The small Hessenberg / Givens state lives on the host in the
working dtype: the stopping test needs the residual estimate on the host
every iteration (every block, below) anyway, and the rotations are a
handful of scalar flops.

Every read of a device value on the host here is inside
utils/timer.py::host_read, which traces it as a "sync" span when tracing
is on.

Iteration blocks: a caller that hands `cg` or `fgmres` a BlockGraphs
(`graphs=`) and whole vectors (`reduce=None`) has its iterations run in
blocks of CG_BLOCK CG iterations or FGMRES_BLOCK Arnoldi steps, each
captured once as a CUDA graph and replayed, with one host read per block
instead of one per iteration.  The eager loop and the blocks call one
step body (`_cg_iteration`, `_arnoldi_step`), FGMRES's cycles and
restarts are one driver over either's Hessenberg columns (`_steps`,
`_blocks`), and both take the same decisions, so the counts, x and the
residual are the eager loop's, to the bit.  The
caller promises that every tensor its `op` and `M` read stays where it is
between solves (written in place), so that a graph captured for one
solve serves the next.  Elsewhere than on a CUDA device the blocks run
uncaptured.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.timer import count, host_read
from . import cuda_ops

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}
# iterations per captured block.  A block past convergence is wasted
# device time (CG: guarded iterations that change nothing; FGMRES: Arnoldi
# steps whose columns are never read), a shorter block one more host read
# and replay: InsIM's inner Mp and Schur CGs take a few iterations per
# solve, its stencil A-solve cycles tens of Arnoldi steps (PERF.md).
# FGMRES_BLOCK divides the A-solve's restart (50); another restart ends
# its cycle with a shorter block.
CG_BLOCK = 4
FGMRES_BLOCK = 5


def clear_cublas_workspaces():
    """Free cuBLAS's cached workspaces (one per handle and stream), as
    torch's CUDA-graph trees do around a capture.  torch has no public
    call for it (torch.cuda.empty_cache() leaves them held): this is the
    private torch._C._cuda_clearCublasWorkspaces, checked against torch
    2.11; a torch without it fails here, by name, not inside a capture."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        raise RuntimeError(
            "torch._C._cuda_clearCublasWorkspaces is gone from torch "
            f"{torch.__version__}: BlockGraphs needs another way to free "
            "cuBLAS's workspaces around a capture")
    clear()


class BlockGraphs:
    """The captured iteration blocks of one solve site (an inner solve
    that a caller runs again and again on operators that read the same
    tensors), the static buffers they read and write, and the host reads
    between them.

    The first solve of a spec (kind, vector shape, dtype, device and the
    solver's limit) takes the eager loop: it builds what the operators
    build on first use (gather plans, cuBLAS's handle), which a capture
    cannot.  Later solves of that spec run blocks: on a CUDA device each
    block is captured the first time it is needed (counted under
    "krylov.graph_captures") and replayed after, all of a site's graphs
    in one memory pool; elsewhere the blocks run uncaptured.  A new spec
    drops the graphs and buffers."""

    def __init__(self, pool=None):
        self.pool = pool
        self.spec = None
        self._buf = {}
        self._graphs = {}
        self._side = None

    def ready(self, spec) -> bool:
        """Whether a solve of `spec` takes blocks: a solve of it ran
        eagerly since the spec last changed."""
        if spec == self.spec:
            return True
        self.spec, self._buf, self._graphs = spec, {}, {}
        return False

    def buffer(self, name, shape, dtype, device):
        """The static tensor `name` (zeros when first made)."""
        t = self._buf.get(name)
        if t is None:
            t = self._buf[name] = torch.zeros(shape, dtype=dtype,
                                              device=device)
        return t

    def run(self, name, fn, device):
        """fn(): on a CUDA device the replay of its graph, captured on the
        first call; elsewhere a plain call.  Returns an event after it on
        the current stream (None off the card).

        A capture runs fn's Python but none of its kernels, so the
        element-matvec launches it counts in cuda_ops.launches are taken
        back out and kept as the graph's table, which every replay adds:
        the counter holds the launches that ran."""
        if device.type != "cuda":
            fn()
            return None
        entry = self._graphs.get(name)
        if entry is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            g = torch.cuda.CUDAGraph()
            before = cuda_ops.launches.copy()
            # as torch's own CUDA-graph trees do: drop cuBLAS's cached
            # workspaces around the capture, so that the one the captured
            # products use is taken from the graphs' pool, not held as a
            # second workspace for the capture stream
            clear_cublas_workspaces()
            with torch.cuda.graph(g, pool=self.pool):
                fn()
            clear_cublas_workspaces()
            table = cuda_ops.launches - before
            cuda_ops.launches.subtract(table)
            for key in table:
                if not cuda_ops.launches[key]:
                    del cuda_ops.launches[key]
            entry = self._graphs[name] = (g, table)
            count("krylov.graph_captures")
        g, table = entry
        g.replay()
        cuda_ops.launches.update(table)
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def read(self, t, site, after=None):
        """t as a NumPy array: one host read.  With `after` (an event of
        run) it waits for that event alone, on a side stream, so that
        blocks queued since keep the device busy."""
        with host_read(site):
            if after is None:
                return t.cpu().numpy()
            if self._side is None:
                self._side = torch.cuda.Stream(device=t.device)
            self._side.wait_event(after)
            with torch.cuda.stream(self._side):
                return t.cpu().numpy()


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _weighted(weight, dtype):
    """Flat weight vector in `dtype`, or None for the plain inner product."""
    return None if weight is None else weight.to(dtype).reshape(-1)


def _wnorm(v, w, reduce=None):
    """sqrt(<v, w v>), or the 2-norm when w is None; with `reduce`, of the
    reduced sum of the partial squares (sqrt(n * n) == n in binary
    floating point, so an identity reduce keeps the bits)."""
    if w is None:
        n = torch.linalg.vector_norm(v)
        return n if reduce is None else torch.sqrt(reduce(n * n))
    v = v.reshape(-1)
    sq = torch.dot(v, w * v)
    return torch.sqrt(sq if reduce is None else reduce(sq))


def _cg_iteration(op, M, dots, x, r, p, rz):
    """One CG iteration from (x, r, p, rz): the eager loop's and the
    blocks' body.  Returns (x, r, p, rz, rr)."""
    Ap = op(p)
    (pAp,) = dots((p, Ap))
    alpha = torch.where(pAp != 0, rz / pAp, 0.0)
    x = x + alpha * p
    r = r - alpha * Ap
    z = M(r)
    rz_new, rr = dots((r, z), (r, r))
    beta = torch.where(rz != 0, rz_new / rz, 0.0)
    return x, r, z + beta * p, rz_new, rr


def cg(op: Callable, b, x0=None, M: Optional[Callable] = None,
       atol=1e-10, maxiter: int = 1000, weight=None,
       reduce: Optional[Callable] = None,
       graphs: Optional[BlockGraphs] = None) -> SolveResult:
    """Preconditioned conjugate gradients; stops when ||r|| <= atol.

    weight: optional nonnegative vector defining a weighted inner product
    <a, b> = sum(w * a * b).  The structured-patch stencil layout
    (la/stencil.py) stores shared nodes once per incident patch; ownership
    weights (1 owned / 0 duplicate) make the duplicated solve exactly
    equivalent to the flat one.

    reduce: optional callable returning the sum over the ranks holding
    pieces of the vectors (parallel/shard.py) of a tensor of partial inner
    products; the two of each iteration that need no other between them
    go in one call.  None for vectors held whole.

    graphs: the site's BlockGraphs; with reduce None the iterations run
    in blocks of CG_BLOCK (module docstring, _cg_blocks)."""
    if M is None:
        M = lambda v: v  # noqa: E731
    w = _weighted(weight, b.dtype)
    dot = _dot if w is None else \
        (lambda a, c: _dot(a, w * c.reshape(-1)))  # noqa: E731

    def dots(*pairs):
        """The inner products of `pairs`, summed over the ranks in one
        reduce (each sum is the one a reduce of it alone gives)."""
        d = [dot(a, c) for a, c in pairs]
        if reduce is None:
            return d
        return list(reduce(torch.stack(d)))
    atol = torch.as_tensor(atol, dtype=b.dtype, device=b.device)
    if graphs is not None and reduce is None and graphs.ready(
            ("cg", tuple(b.shape), b.dtype, b.device, maxiter)):
        return _cg_blocks(op, b, x0, M, atol, maxiter, w, graphs)
    x = torch.zeros_like(b) if x0 is None else x0

    def above(rr):
        """The loop test: ||r|| > atol, read on the host."""
        test = torch.sqrt(rr) > atol
        with host_read("cg_test"):
            return bool(test)

    r = b - op(x)
    z = M(r)
    p = z
    rz, rr = dots((r, z), (r, r))
    k = 0
    while k < maxiter and above(rr):
        x, r, p, rz, rr = _cg_iteration(op, M, dots, x, r, p, rz)
        k += 1
    res = torch.sqrt(rr)
    with host_read("cg_residual"):
        res = float(res)
    if graphs is not None:
        count("krylov.eager_iters", k)
    return SolveResult(x=x, iters=k, residual=res)


def _cg_blocks(op, b, x0, M, atol, maxiter, w, graphs):
    """cg's iterations in blocks of CG_BLOCK, in `graphs`' static
    buffers.  Each iteration of a block first takes the eager loop's test
    (k < maxiter and sqrt(rr) > atol) on the device and, where it fails,
    leaves x, r, p, rz, rr and k exactly as they were (torch.where), so a
    block past convergence changes nothing.  A block ends by writing
    (the test for the next iteration, k, sqrt(rr)), which the host reads
    once per block.  The first block also forms the start (r = b - A x0,
    z = M r, p = z)."""
    dev, dt, shape = b.device, b.dtype, tuple(b.shape)

    def buf(name, shp=shape, dtype=dt):
        return graphs.buffer(name, shp, dtype, dev)
    bs, at, xs = buf("b"), buf("atol", ()), buf("x")
    rs, ps, rzs, rrs = buf("r"), buf("p"), buf("rz", ()), buf("rr", ())
    ks = buf("k", (), torch.int64)
    status = buf("status", (3,), torch.float64)
    bs.copy_(b)
    at.copy_(atol)
    if x0 is None:
        xs.zero_()
    else:
        xs.copy_(x0)
    if w is not None:
        w = buf("w", tuple(w.shape)).copy_(w)
        dot = lambda a, c: _dot(a, w * c.reshape(-1))  # noqa: E731
    else:
        dot = _dot

    def dots(*pairs):
        return [dot(a, c) for a, c in pairs]

    def test():
        return (ks < maxiter) & (torch.sqrt(rrs) > at)

    def iterate():
        for _ in range(CG_BLOCK):
            go = test()
            new = _cg_iteration(op, M, dots, xs, rs, ps, rzs)
            for old, v in zip((xs, rs, ps, rzs, rrs), new):
                old.copy_(torch.where(go, v, old))
            ks.add_(go.to(torch.int64))
        status.copy_(torch.stack([test().to(torch.float64),
                                  ks.to(torch.float64),
                                  torch.sqrt(rrs).to(torch.float64)]))

    def first():
        r = bs - op(xs)
        z = M(r)
        rz, rr = dots((r, z), (r, r))
        for old, v in ((rs, r), (ps, z), (rzs, rz), (rrs, rr)):
            old.copy_(v)
        ks.zero_()
        iterate()

    name, fn = "first", first
    while True:
        graphs.run(name, fn, dev)
        go, k, res = graphs.read(status, "cg_block")
        name, fn = "next", iterate
        if not go:
            break
    count("krylov.graph_iters", int(k))
    return SolveResult(x=xs.clone(), iters=int(k), residual=float(res))


def _back_substitute(H, g, k):
    """Solve the upper-triangular (k x k) system H[:k, :k] y = g[:k]."""
    y = np.zeros(k, dtype=H.dtype)
    for i in range(k - 1, -1, -1):
        y[i] = (g[i] - H[i, i + 1:k] @ y[i + 1:k]) / H[i, i]
    return y


def _arnoldi_step(op, M, V, Z, k, w8, reduce=None):
    """Arnoldi step k of an FGMRES cycle, the eager loop's and the blocks'
    body: z = M(V[k]) into Z[k], w = op(z) orthogonalised against V[:k+1]
    by CGS2 (two classical Gram-Schmidt passes) in the w8-weighted inner
    product and normalised into V[k+1].  Returns the Hessenberg column
    (h[0..k], ||w||) on the device."""
    red = (lambda h: h) if reduce is None else reduce  # noqa: E731
    z = M(V[k])
    w = op(z)
    Z[k] = z
    Vk = V[:k + 1].reshape(k + 1, -1)
    h1 = red(Vk @ (w.reshape(-1) if w8 is None else w8 * w.reshape(-1)))
    w = w - (h1 @ Vk).reshape(w.shape)
    h2 = red(Vk @ (w.reshape(-1) if w8 is None else w8 * w.reshape(-1)))
    w = w - (h2 @ Vk).reshape(w.shape)
    wn = _wnorm(w, w8, reduce)
    V[k + 1] = torch.where(wn > 0, w / torch.where(wn > 0, wn, 1.0), 0.0)
    return torch.cat([h1 + h2, wn.reshape(1)])


def _rotate(H, cs, sn, g, k, hw):
    """Put the Hessenberg column hw (h[0..k+1]) of step k into H after the
    previous Givens rotations and a new one, which also rotates g.
    Returns the residual estimate |g[k+1]|."""
    ndt = H.dtype.type
    Hcol = np.zeros(H.shape[0], dtype=H.dtype)
    Hcol[:k + 2] = hw[:k + 2]
    for i in range(k):
        hi = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
        hi1 = -sn[i] * Hcol[i] + cs[i] * Hcol[i + 1]
        Hcol[i], Hcol[i + 1] = hi, hi1
    denom = np.sqrt(Hcol[k] ** 2 + Hcol[k + 1] ** 2)
    if denom > 0:
        c_new, s_new = Hcol[k] / denom, Hcol[k + 1] / denom
    else:
        c_new, s_new = ndt(1.0), ndt(0.0)
    Hcol[k] = c_new * Hcol[k] + s_new * Hcol[k + 1]
    Hcol[k + 1] = 0.0
    H[:, k] = Hcol
    cs[k], sn[k] = c_new, s_new
    gk1 = -s_new * g[k]
    g[k] = c_new * g[k]
    g[k + 1] = gk1
    return np.abs(gk1)


def _cycle_tables(restart, ndt, beta):
    """The host's Hessenberg, Givens and rhs tables of a cycle."""
    g = np.zeros(restart + 1, dtype=ndt)
    g[0] = beta
    return (np.zeros((restart + 1, restart), dtype=ndt),
            np.zeros(restart, dtype=ndt), np.zeros(restart, dtype=ndt), g)


def _steps(op, M, b, restart, w8, reduce):
    """The eager loop's cycles for _fgmres_cycle: a new basis each cycle,
    and Arnoldi step k run and its column read on the host when column k
    is asked for."""
    def cycle():
        V = torch.zeros((restart + 1,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)
        Z = torch.zeros((restart,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)

        def columns():
            for k in range(restart):
                hw = _arnoldi_step(op, M, V, Z, k, w8, reduce)
                with host_read("fgmres_hcol"):
                    hw = hw.cpu().numpy()
                yield hw
        return V, Z, columns()
    return cycle


def _blocks(op, M, b, restart, w8, graphs):
    """The iteration blocks' cycles for _fgmres_cycle: `graphs`' static
    basis V, Z and Hessenberg rows, and the Arnoldi steps in blocks of
    FGMRES_BLOCK (a shorter last one where it does not divide the
    restart), each a replayed graph that writes its steps' rows on the
    device.  Block i+1 is queued before block i's rows are read, so the
    device always has work; a cycle that stops inside block i leaves at
    most block i+1 running unneeded, and its steps write only rows and
    columns that the cycle's end never reads."""
    dev, dt = b.device, b.dtype
    V = graphs.buffer("V", (restart + 1,) + tuple(b.shape), dt, dev)
    Z = graphs.buffer("Z", (restart,) + tuple(b.shape), dt, dev)
    Hd = graphs.buffer("H", (restart, restart + 1), dt, dev)
    if w8 is not None:
        w8 = graphs.buffer("w", tuple(w8.shape), dt, dev).copy_(w8)
    blocks = [(k0, min(FGMRES_BLOCK, restart - k0))
              for k0 in range(0, restart, FGMRES_BLOCK)]

    def launch(i):
        k0, n = blocks[i]

        def fn():
            for k in range(k0, k0 + n):
                Hd[k, :k + 2] = _arnoldi_step(op, M, V, Z, k, w8)
        return graphs.run(blocks[i], fn, dev)

    def columns():
        ev = launch(0)
        for i, (k0, n) in enumerate(blocks):
            ev_next = launch(i + 1) if i + 1 < len(blocks) else None
            yield from graphs.read(Hd[k0:k0 + n], "fgmres_block", ev)
            ev = ev_next
    return lambda: (V, Z, columns())


def _fgmres_cycle(cycle, x0, r0, beta, atol, restart: int, ndt):
    """One FGMRES(restart) cycle from x0, whose residual r0 has the norm
    beta (read on the host).  cycle() gives the basis V, Z and the
    iterator of the Hessenberg columns (h[0..k+1] of step k, on the host;
    _steps or _blocks), which the host rotates in order until the
    estimate is <= atol.  Returns (x, resnorm, iters)."""
    V, Z, columns = cycle()
    H, cs, sn, g = _cycle_tables(restart, ndt, beta)
    V[0] = r0 / (float(beta) if beta > 0 else 1.0)
    k, res = 0, beta
    while res > atol and k < restart:
        res = _rotate(H, cs, sn, g, k, next(columns))
        k += 1
    if k == 0:
        return x0, res, 0
    y = torch.as_tensor(_back_substitute(H, g, k), device=x0.device)
    x = x0 + torch.tensordot(y, Z[:k], dims=([0], [0]))
    return x, res, k


def fgmres(op: Callable, b, x0=None, M: Optional[Callable] = None,
           atol=1e-10, restart: int = 50, max_restarts: int = 4,
           weight=None, reduce: Optional[Callable] = None,
           graphs: Optional[BlockGraphs] = None) -> SolveResult:
    """Flexible right-preconditioned GMRES with restarts (weight, reduce,
    graphs: see cg; with the blocks, each cycle's Arnoldi steps are
    _blocks').

    weight: Arnoldi in the weighted inner product: the CGS2 projections
    become V @ (w * v) and the norms sqrt(<v, w v>).  reduce: applied to
    each norm's partial square and, once per CGS2 pass, to the whole
    vector of projections.  Each cycle starts from r = b - A x and its
    norm, read on the host; the first cycle's norm is the initial
    residual's, read together with atol where atol is a device value."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda v: v  # noqa: E731
    ndt = _NP_DTYPE[b.dtype]
    w8 = _weighted(weight, b.dtype)
    blocked = graphs is not None and reduce is None and graphs.ready(
        ("fgmres", tuple(b.shape), b.dtype, b.device, restart))
    cycle = _blocks(op, M, b, restart, w8, graphs) if blocked else \
        _steps(op, M, b, restart, w8, reduce)

    def start(x):
        r0 = b - op(x)
        return r0, _wnorm(r0, w8, reduce)

    r0, beta = start(x0)
    if isinstance(atol, torch.Tensor):
        atol = atol.reshape(()).to(b.device, b.dtype)
        with host_read("fgmres_start"):
            atol, beta = torch.stack([atol, beta]).cpu().numpy()
    else:
        with host_read("fgmres_norm"):
            beta = beta.item()
    atol, res = ndt(atol), ndt(beta)
    x, total_k, cyc = x0, 0, 0
    while res > atol and cyc < max_restarts:
        if cyc:
            r0, beta = start(x)
            with host_read("fgmres_norm"):
                beta = beta.item()
        x, res, k = _fgmres_cycle(cycle, x, r0, ndt(beta), atol, restart,
                                  ndt)
        total_k += k
        cyc += 1
    if graphs is not None:
        count("krylov.graph_iters" if blocked else "krylov.eager_iters",
              total_k)
    return SolveResult(x=x, iters=total_k, residual=float(res))
