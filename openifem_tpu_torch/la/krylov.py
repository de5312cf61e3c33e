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
every iteration anyway, and the rotations are a handful of scalar flops.

Every read of a device value on the host here is inside
utils/timer.py::host_read, which traces it as a "sync" span when tracing
is on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.timer import host_read

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


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


def cg(op: Callable, b, x0=None, M: Optional[Callable] = None,
       atol=1e-10, maxiter: int = 1000, weight=None,
       reduce: Optional[Callable] = None) -> SolveResult:
    """Preconditioned conjugate gradients; stops when ||r|| <= atol.

    weight: optional nonnegative vector defining a weighted inner product
    <a, b> = sum(w * a * b).  The structured-patch stencil layout
    (la/stencil.py) stores shared nodes once per incident patch; ownership
    weights (1 owned / 0 duplicate) make the duplicated solve exactly
    equivalent to the flat one.

    reduce: optional callable returning the sum over the ranks holding
    pieces of the vectors (parallel/shard.py) of a tensor of partial inner
    products; the two of each iteration that need no other between them
    go in one call.  None for vectors held whole."""
    x = torch.zeros_like(b) if x0 is None else x0
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
        Ap = op(p)
        (pAp,) = dots((p, Ap))
        alpha = torch.where(pAp != 0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr = dots((r, z), (r, r))
        beta = torch.where(rz != 0, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        k += 1
    res = torch.sqrt(rr)
    with host_read("cg_residual"):
        res = float(res)
    return SolveResult(x=x, iters=k, residual=res)


def _back_substitute(H, g, k):
    """Solve the upper-triangular (k x k) system H[:k, :k] y = g[:k]."""
    y = np.zeros(k, dtype=H.dtype)
    for i in range(k - 1, -1, -1):
        y[i] = (g[i] - H[i, i + 1:k] @ y[i + 1:k]) / H[i, i]
    return y


def _fgmres_cycle(op, M, x0, b, atol, restart: int, weight=None,
                  reduce=None):
    """One FGMRES(restart) cycle.  Returns (x, resnorm, iters).

    weight: optional weighted-inner-product vector (see cg): the CGS2
    projections become V @ (w * v) and the norms sqrt(<v, w v>), i.e.
    Arnoldi in the weighted inner product.  reduce (see cg): applied to
    each norm's partial square and, once per CGS2 pass, to the whole
    vector of projections."""
    ndt = _NP_DTYPE[b.dtype]
    w8 = _weighted(weight, b.dtype)
    red = (lambda h: h) if reduce is None else reduce  # noqa: E731
    r0 = b - op(x0)
    beta = _wnorm(r0, w8, reduce)
    with host_read("fgmres_norm"):
        beta = ndt(beta.item())

    V = torch.zeros((restart + 1,) + tuple(b.shape), dtype=b.dtype,
                    device=b.device)
    Z = torch.zeros((restart,) + tuple(b.shape), dtype=b.dtype,
                    device=b.device)
    H = np.zeros((restart + 1, restart), dtype=ndt)
    cs = np.zeros(restart, dtype=ndt)
    sn = np.zeros(restart, dtype=ndt)
    g = np.zeros(restart + 1, dtype=ndt)

    V[0] = r0 / (float(beta) if beta > 0 else 1.0)
    g[0] = beta
    k, res = 0, beta
    while res > atol and k < restart:
        z = M(V[k])
        w = op(z)
        Z[k] = z
        # CGS2: two classical Gram-Schmidt passes against V[0..k]
        Vk = V[:k + 1].reshape(k + 1, -1)
        h1 = red(Vk @ (w.reshape(-1) if w8 is None else
                       w8 * w.reshape(-1)))
        w = w - (h1 @ Vk).reshape(w.shape)
        h2 = red(Vk @ (w.reshape(-1) if w8 is None else
                       w8 * w.reshape(-1)))
        w = w - (h2 @ Vk).reshape(w.shape)
        wn = _wnorm(w, w8, reduce)
        V[k + 1] = torch.where(wn > 0, w / torch.where(wn > 0, wn, 1.0),
                               0.0)
        hw = torch.cat([h1 + h2, wn.reshape(1)])
        with host_read("fgmres_hcol"):
            hw = hw.cpu().numpy()
        Hcol = np.zeros(restart + 1, dtype=ndt)
        Hcol[:k + 1] = hw[:k + 1]
        Hcol[k + 1] = hw[k + 1]
        # apply the previous Givens rotations to the new column
        for i in range(k):
            hi = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
            hi1 = -sn[i] * Hcol[i] + cs[i] * Hcol[i + 1]
            Hcol[i], Hcol[i + 1] = hi, hi1
        # new rotation
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
        res = np.abs(gk1)
        k += 1

    if k == 0:
        return x0, res, 0
    y = torch.as_tensor(_back_substitute(H, g, k), device=b.device)
    x = x0 + torch.tensordot(y, Z[:k], dims=([0], [0]))
    return x, res, k


def fgmres(op: Callable, b, x0=None, M: Optional[Callable] = None,
           atol=1e-10, restart: int = 50, max_restarts: int = 4,
           weight=None, reduce: Optional[Callable] = None) -> SolveResult:
    """Flexible right-preconditioned GMRES with restarts (weight, reduce:
    see cg)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda v: v  # noqa: E731
    ndt = _NP_DTYPE[b.dtype]
    if isinstance(atol, torch.Tensor):
        with host_read("fgmres_atol"):
            atol = float(atol)
    atol = ndt(atol)
    x = x0
    res = _wnorm(b - op(x0), _weighted(weight, b.dtype), reduce)
    with host_read("fgmres_norm"):
        res = ndt(res.item())
    total_k, cyc = 0, 0
    while res > atol and cyc < max_restarts:
        x, res, k = _fgmres_cycle(op, M, x, b, atol, restart, weight,
                                  reduce)
        total_k += k
        cyc += 1
    return SolveResult(x=x, iters=total_k, residual=float(res))
