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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg(op: Callable, b, x0=None, M: Optional[Callable] = None,
       atol=1e-10, maxiter: int = 1000) -> SolveResult:
    """Preconditioned conjugate gradients; stops when ||r|| <= atol."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        M = lambda v: v  # noqa: E731
    atol = torch.as_tensor(atol, dtype=b.dtype, device=b.device)

    r = b - op(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    k = 0
    while k < maxiter and bool(torch.sqrt(_dot(r, r)) > atol):
        Ap = op(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp != 0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = torch.where(rz != 0, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        k += 1
    return SolveResult(x=x, iters=k, residual=float(torch.sqrt(_dot(r, r))))


def _back_substitute(H, g, k):
    """Solve the upper-triangular (k x k) system H[:k, :k] y = g[:k]."""
    y = np.zeros(k, dtype=H.dtype)
    for i in range(k - 1, -1, -1):
        y[i] = (g[i] - H[i, i + 1:k] @ y[i + 1:k]) / H[i, i]
    return y


def _fgmres_cycle(op, M, x0, b, atol, restart: int):
    """One FGMRES(restart) cycle.  Returns (x, resnorm, iters)."""
    ndt = _NP_DTYPE[b.dtype]
    r0 = b - op(x0)
    beta = ndt(torch.linalg.vector_norm(r0).item())

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
        h1 = Vk @ w.reshape(-1)
        w = w - (h1 @ Vk).reshape(w.shape)
        h2 = Vk @ w.reshape(-1)
        w = w - (h2 @ Vk).reshape(w.shape)
        wn = torch.linalg.vector_norm(w)
        V[k + 1] = torch.where(wn > 0, w / torch.where(wn > 0, wn, 1.0),
                               0.0)
        hw = torch.cat([h1 + h2, wn.reshape(1)]).cpu().numpy()
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
           atol=1e-10, restart: int = 50,
           max_restarts: int = 4) -> SolveResult:
    """Flexible right-preconditioned GMRES with restarts."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda v: v  # noqa: E731
    ndt = _NP_DTYPE[b.dtype]
    atol = ndt(float(atol))
    x = x0
    res = ndt(torch.linalg.vector_norm(b - op(x0)).item())
    total_k, cyc = 0, 0
    while res > atol and cyc < max_restarts:
        x, res, k = _fgmres_cycle(op, M, x, b, atol, restart)
        total_k += k
        cyc += 1
    return SolveResult(x=x, iters=total_k, residual=float(res))
