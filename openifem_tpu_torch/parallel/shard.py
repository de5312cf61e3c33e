"""Multi-rank sharding: element-block domain decomposition over ranks.

Counterpart of openifem_tpu/parallel/shard.py.  The reference parallelizes
by domain decomposition: p4est partitions fluid cells across MPI ranks,
assembly is rank-local, and PETSc reduces the halo (SURVEY.md section 1).
The JAX package gets the same from GSPMD over a device mesh; here each
rank is a process of a torch.distributed group and every collective is
written out (`Collectives`).

  CellMesh        the counterpart of the JAX `Mesh` over the "cells"
                  axis: process group, rank, size, device, backend.
  spawn_ranks     runs a function in n spawned ranks (FileStore
                  rendezvous) and returns rank 0's result.

Two ways of splitting the work, as in the JAX package:

  * replicated Krylov vectors with cell-sharded element work
    (shard_fluid_solver, sharded_insim_newton, make_sharded_stepper,
    sharded_supg_newton): each rank assembles its contiguous cell range;
    every element-block apply and diagonal covers the rank's cells and is
    summed over the ranks with one all-reduce (`cell_reduce`); every rank
    then runs the same Krylov arithmetic on whole vectors.  The JAX
    package range-shards these vectors inside its preconditioners under
    GSPMD; the solve is the same.
  * sharded vectors for the two functions that own their Krylov loop:
    sharded_element_cg (dof ranges of a padded layout: all-gather, local
    apply, reduce-scatter) and ShardedStencil / sharded_stencil_asolve
    (plane chunks of one stencil brick with a k-plane halo exchange).
    Their inner products go through la/krylov.py's `reduce=`.

The padded layouts are the JAX package's (n_u padded to a multiple of
lcm(ranks, dim), n_p to one of ranks, pad cells of zero blocks pointing at
the last pad dof), so a rank owns the same cells and dofs as the JAX
device of its index.  The element-block applies run the hand-written CUDA
kernel on a rank's cells (la/operators.py).

Backend rule (`backend_for`): NCCL when every rank has its own card,
gloo otherwise (the CPU, or ranks sharing one card).  Gloo takes CUDA
tensors for all_reduce only (PyTorch's torch.distributed "Backends"
table); its other collectives of CUDA tensors are staged through pinned
host buffers.  The route of each collective is fixed when the mesh is
made and printed by the callers; nothing is retried on another route.
"""

from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time
import traceback
import types
from collections import Counter
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import device as _device
from ..config import index_dtype
from ..la.constraints import Constraints
from ..la.krylov import SolveResult, cg, fgmres
from ..la.operators import (element_diag, element_matvec,
                            element_matvec_taylor_hood)

# rendezvous and collective timeout of every rank's process group
GROUP_TIMEOUT_S = 60
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter",
               "neighbour_exchange")


def _pad(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def backend_for(device, n_ranks: int) -> str:
    """NCCL when each of n_ranks ranks has a card of its own, gloo
    otherwise (the CPU, or ranks that share a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclass
class CellMesh:
    """The ranks of the default process group as one "cells" axis."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    coll: "Collectives" = field(init=False, repr=False)

    def __post_init__(self):
        self.coll = Collectives(self)


def make_cell_mesh(n_devices: Optional[int] = None, device=None
                   ) -> CellMesh:
    """The mesh over the initialised default group (spawn_ranks starts one
    in each rank).  A rank takes cuda:<rank % device_count>, or the CPU
    when device="cpu" (config.device's rule).  n_devices, when given,
    must be the group's size: the port has no virtual devices."""
    if not dist.is_initialized():
        raise RuntimeError("make_cell_mesh needs an initialised default "
                           "process group (spawn_ranks starts one per "
                           "rank)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_cell_mesh({n_devices}) in a group of "
                         f"{size} ranks")
    dev = _device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return CellMesh(dist.group.WORLD, rank, size, dev, dist.get_backend())


class Collectives:
    """Every collective of this module.  routes[name] is fixed by the
    backend and the device when the mesh is made: "nccl", "gloo", or
    "gloo via pinned host" for a CUDA tensor under gloo (which takes CUDA
    tensors for all_reduce only).  Gloo has no reduce-scatter: it is an
    all-reduce and the rank's slice.  calls / nbytes count each
    collective and the bytes this rank hands it; staged_bytes the bytes
    copied through host buffers; they only grow (counts())."""

    def __init__(self, mesh: CellMesh):
        self.mesh, self.group = mesh, mesh.group
        self.rank, self.size = mesh.rank, mesh.size
        nccl = mesh.backend == "nccl"
        staged = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self.routes = {}
        for name in COLLECTIVES:
            if nccl:
                route = "nccl"
            elif name == "all_reduce" or not staged:
                route = "gloo"
            else:
                route = "gloo via pinned host"
            if name == "reduce_scatter" and not nccl:
                route = "all_reduce + slice"
            self.routes[name] = route
        self._staged = staged
        self._host = {}
        self.calls = Counter()
        self.nbytes = Counter()
        self.staged_bytes = 0

    def counts(self):
        """A snapshot of calls, nbytes and staged_bytes (nothing resets
        them: a caller that wants a span's counts takes the difference of
        two snapshots)."""
        return dict(calls=self.calls.copy(), nbytes=self.nbytes.copy(),
                    staged=self.staged_bytes)

    def _count(self, name, t):
        self.calls[name] += 1
        self.nbytes[name] += t.numel() * t.element_size()

    def _to_host(self, t, slot):
        """t copied into a pinned host buffer kept per (slot, shape,
        dtype)."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host[key] = buf
        buf.copy_(t)
        self.staged_bytes += t.numel() * t.element_size()
        return buf

    def _to_device(self, h):
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(self.mesh.device)

    def all_reduce_sum(self, t):
        """The sum of t over the ranks, in place (t is returned)."""
        flat = t.reshape(-1)
        if not flat.is_contiguous() or flat.data_ptr() != t.data_ptr():
            raise ValueError("all_reduce_sum takes a contiguous tensor")
        self._count("all_reduce", t)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather_cat(self, t, dim: int = 0):
        """Every rank's t (equal shapes), concatenated along `dim` in rank
        order."""
        self._count("all_gather", t)
        src = self._to_host(t, "gather") if self._staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        return self._to_device(out) if self._staged else out

    def reduce_scatter_sum(self, t):
        """This rank's slice (of size / ranks, along dim 0) of the sum of
        t over the ranks."""
        m = t.shape[0] // self.size
        self._count("reduce_scatter", t)
        if self.mesh.backend == "nccl":
            out = torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, t.contiguous(),
                                       group=self.group)
            return out
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t[self.rank * m:(self.rank + 1) * m]

    def neighbour_exchange(self, lo, hi):
        """(from_prev, from_next): the previous rank's `hi` and the next
        rank's `lo` (this rank sends lo to rank - 1 and hi to rank + 1),
        the counterpart of lax.ppermute with the pairs (i, i+1) and
        (i, i-1).  Zeros where there is no neighbour, as ppermute
        leaves them."""
        self._count("neighbour_exchange", lo)
        self._count("neighbour_exchange", hi)
        staged = self._staged
        if staged:
            lo, hi = self._to_host(lo, "lo"), self._to_host(hi, "hi")
        else:
            lo, hi = lo.contiguous(), hi.contiguous()
        from_prev, from_next = torch.zeros_like(hi), torch.zeros_like(lo)
        ops = []
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, lo, self.rank - 1, self.group),
                    dist.P2POp(dist.irecv, from_prev, self.rank - 1,
                               self.group)]
        if self.rank < self.size - 1:
            ops += [dist.P2POp(dist.isend, hi, self.rank + 1, self.group),
                    dist.P2POp(dist.irecv, from_next, self.rank + 1,
                               self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if staged:
            return self._to_device(from_prev), self._to_device(from_next)
        return from_prev, from_next


# ----------------------------------------------------------------------
# Ranks
# ----------------------------------------------------------------------

def _rank_main(fn, rank, n_ranks, device, backend, store, results, args):
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=n_ranks, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        out = fn(make_cell_mesh(device=device), *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, device, *args, timeout: float = 900.0,
                all_ranks: bool = False):
    """fn(mesh, *args) in n_ranks spawned processes, each a rank of a new
    process group (backend_for's rule, printed) that meets through a
    FileStore in a temporary directory.  Returns rank 0's result, or with
    all_ranks the list of every rank's.  fn must be importable by name
    (a module-level function) and return picklable values (numpy).  A rank
    that raises, or dies, makes this raise with its traceback, and so does
    a run longer than `timeout` seconds; every rank is stopped before
    this returns or raises."""
    import torch.multiprocessing as mp
    backend = backend_for(device, n_ranks)
    print(f"spawn_ranks: {n_ranks} ranks on {device}, backend {backend}",
          flush=True)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="openifem_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, n_ranks, str(device), backend, os.path.join(tmp, "store"),
        results, args)) for r in range(n_ranks)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(n_ranks)) - set(got))
                raise TimeoutError(f"spawn_ranks: ranks {late} did not "
                                   f"finish in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                # a rank that raised reported before it died: read that
                try:
                    rank, ok, out = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(f"spawn_ranks: ranks died with "
                                       f"exit codes {dead}") from None
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {rank} raised:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawn_ranks: ranks ended with exit codes "
                               f"{bad}")
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(n_ranks)] if all_ranks else got[0]


def cell_range(n_cells: int, mesh: CellMesh):
    """(first, end, per) of this rank's cells in the padded partition:
    `per` cells a rank, the last ranks' tails past n_cells being pad
    cells; first and end are clipped to n_cells."""
    per = -(-n_cells // mesh.size)
    first = min(mesh.rank * per, n_cells)
    return first, min(first + per, n_cells), per


# ----------------------------------------------------------------------
# Element sharding of a solver (replicated dof vectors)
# ----------------------------------------------------------------------

# cell-indexed solver arrays that the assemblies and preconditioners read
_CELL_ATTRS = ("gu", "gp", "JxW", "gravity_q", "sigma_pml_q",
               "_u_cell_nodes", "_p_cell_nodes", "cell_dofs", "cell_dofs_u",
               "cell_dofs_p", "cell_nodes_u", "Mp_loc", "_A_const", "_gu_m",
               "_JxW_m")


class _RankView:
    """A solver as one rank sees it: the attributes given here (its own
    cells' tables, cell_reduce, the padded layout's sizes) and everything
    else read from the solver, the knobs of its preconditioner included;
    the solver's class methods run on the view."""

    def __init__(self, solver, **own):
        self.__dict__["_solver"] = solver
        self.__dict__.update(own)

    def __getattr__(self, name):
        solver = self.__dict__["_solver"]
        fn = getattr(type(solver), name, None)
        if isinstance(fn, types.FunctionType):
            return types.MethodType(fn, self)
        return getattr(solver, name)


def _cell_args(solver):
    """Positions of the cell-indexed arguments of solver._assemble:
    (indicator, fsi_acc, fsi_stress) for InsIM, the indicator for the
    SUPG family."""
    from ..solvers.fluid.supg import SUPGFluidSolver
    return (2,) if isinstance(solver, SUPGFluidSolver) else (2, 3, 4)


def _rank_view(solver, mesh: CellMesh, first: int, end: int):
    """The view of `solver` that assembles cells [first, end) and reduces:
    its _assemble returns (own cells' blocks, the rhs summed over the
    ranks), its applies carry cell_reduce, and it takes the element
    branch (the stencils need every cell's block; ShardedStencil is the
    sharded stencil)."""
    coll = mesh.coll
    own = {name: getattr(solver, name)[first:end] for name in _CELL_ATTRS
           if getattr(solver, name, None) is not None}
    neumann = solver._neumann_rhs_const
    view = _RankView(
        solver, cell_reduce=coll.all_reduce_sum, _u_stencil=None,
        _sys_stencil=None,
        # added once: the rank 0 copy
        _neumann_rhs_const=neumann if mesh.rank == 0
        else torch.zeros_like(neumann), **own)
    cell_args = _cell_args(solver)
    assemble = type(solver)._assemble

    def own_assemble(*args):
        args = [a[first:end] if i in cell_args else a
                for i, a in enumerate(args)]
        A_loc, rhs = assemble(view, *args)
        return A_loc, coll.all_reduce_sum(rhs)
    view.__dict__["_assemble"] = own_assemble
    return view


def _refuse_whole_cell_branches(solver, what: str):
    """Raise for the dense and multigrid preconditioners, which need every
    cell's block."""
    for knob in ("dense_precond", "_pressure_mg", "_velocity_mg"):
        if getattr(solver, knob, None):
            raise NotImplementedError(
                f"{what}: {knob} needs every cell's block")


def shard_fluid_solver(solver, mesh: CellMesh):
    """Shard a set-up fluid solver's Newton iteration over the mesh's
    ranks: each rank assembles its contiguous cell range, every
    element-block apply (outer Jacobian, preconditioner blocks and
    diagonals) launches on the rank's cells and is summed with one
    all-reduce, and the dof vectors stay whole on every rank.  The solver
    then runs its own run_one_step, stepper, or FSI / MPIFSI coupled step;
    everything outside the Newton solve (stress, coupling) stays
    replicated.  The A-solve takes the element branch.  Raises for the
    dense and multigrid preconditioners, which need every cell's block."""
    _refuse_whole_cell_branches(solver, "shard_fluid_solver")
    first, end, _ = cell_range(solver.mesh.n_cells, mesh)
    view = _rank_view(solver, mesh, first, end)
    sharded_mesh = solver.mesh
    impl = type(solver)._newton_iter_impl

    def newton_iter_impl(*args, **kw):
        if solver.mesh is not sharded_mesh:
            raise RuntimeError("the solver's mesh changed after "
                               "shard_fluid_solver: shard it again")
        return impl(view, *args, **kw)
    solver._newton_iter_impl = newton_iter_impl
    if hasattr(solver, "_newton_iter"):
        solver._newton_iter = newton_iter_impl
    solver.rank_view = view
    return solver


# ----------------------------------------------------------------------
# Dof-range sharding (padded layouts)
# ----------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _pad_constraints(cons, n_pad: int):
    """Extend a Constraints object to n_pad dofs; the tail rows are
    Dirichlet-fixed at zero so they stay exact identity rows in the
    condensed Krylov system."""
    n = cons.n_dofs
    hidx = _np(cons.hang_idx)
    k = hidx.shape[1]
    hang_idx = np.concatenate([
        hidx, np.tile(np.arange(n, n_pad, dtype=hidx.dtype)[:, None],
                      (1, k))])
    hw_pad = np.zeros((n_pad - n, k))
    hw_pad[:, 0] = 1.0
    hang_w = np.concatenate([_np(cons.hang_w), hw_pad])
    hanging = np.concatenate([_np(cons.hanging),
                              np.zeros(n_pad - n, dtype=bool)])
    dmask = np.concatenate([_np(cons.dirichlet),
                            np.ones(n_pad - n, dtype=bool)])
    dvals = np.concatenate([_np(cons.dirichlet_values), np.zeros(n_pad - n)])
    return Constraints(n_pad, hang_idx, hang_w, hanging, dmask, dvals,
                       device=cons.fixed.device)


def _rank_cells(arr, mesh: CellMesh, fill=None, dtype=None):
    """This rank's slice of the cell-indexed `arr` padded to a multiple of
    the ranks (zero blocks, or index `fill`), as a contiguous tensor on
    arr's device."""
    n_c = arr.shape[0]
    first, end, per = cell_range(n_c, mesh)
    own = arr[first:end]
    n_zero = per - (end - first)
    if n_zero:
        tail = (torch.zeros if fill is None else
                (lambda shape, **kw: torch.full(shape, fill, **kw)))(
            (n_zero,) + tuple(arr.shape[1:]), dtype=arr.dtype,
            device=arr.device)
        own = torch.cat([own, tail])
    return own.to(dtype or arr.dtype).contiguous()


def sharded_element_cg(A_loc, cell_dofs, cons, mesh: CellMesh,
                       maxiter: int = None):
    """Sharded Jacobi-CG solve for an element-block operator.

    Counterpart of the reference's distributed PETSc CG
    (source/mpi_solid_solver.cpp:145-160): element blocks are split by
    cells and the dof vectors by ranges of a padded layout.  Each apply
    all-gathers x, applies the rank's blocks and reduce-scatters to the
    rank's range; the CG dots are summed over the ranks.

    Returns solve(b, atol) -> SolveResult on the original (unpadded)
    layout, x whole on every rank; solve.tables holds the rank's table
    (for kernel checks)."""
    coll = mesh.coll
    n = cons.n_dofs
    n_pad = _pad(n, mesh.size)
    m = n_pad // mesh.size
    lo = mesh.rank * m
    pcons = _pad_constraints(cons, n_pad)
    pad_dof = n_pad - 1 if n_pad > n else 0
    A_own = _rank_cells(A_loc, mesh)
    cd_own = _rank_cells(cell_dofs, mesh, fill=pad_dof, dtype=index_dtype)
    fixed_own = pcons.fixed[lo:lo + m]

    def apply(x):
        xf = coll.all_gather_cat(x)
        y = pcons.restrict(element_matvec(A_own, cd_own, n_pad,
                                          pcons.expand(xf)))
        return torch.where(fixed_own, x, coll.reduce_scatter_sum(y))
    diag = torch.where(fixed_own, 1.0, coll.reduce_scatter_sum(
        element_diag(A_own, cd_own, n_pad)))
    dinv = torch.where(diag != 0, 1.0 / diag, 1.0)
    if maxiter is None:
        maxiter = n

    def solve(b, atol):
        b_pad = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
        b_pad[:n] = b
        res = cg(apply, b_pad[lo:lo + m].contiguous(),
                 M=lambda r: r * dinv, atol=atol, maxiter=maxiter,
                 reduce=coll.all_reduce_sum)
        return SolveResult(coll.all_gather_cat(res.x)[:n], res.iters,
                           res.residual)
    solve.tables = types.SimpleNamespace(
        cell_dofs=cd_own, n_dofs=n_pad,
        mesh=types.SimpleNamespace(n_cells=A_own.shape[0]))
    return solve


def shard_solid_solver(solver, mesh: CellMesh):
    """Swap a set-up solid's CG closures (_solve_A, _solve_M) for
    sharded_element_cg ones; its run_one_step then solves over the
    ranks."""
    if getattr(solver, "A_loc", None) is not None:
        solver._solve_A = sharded_element_cg(
            solver.A_loc, solver.cell_dofs, solver.constraints, mesh)
    if getattr(solver, "M_loc", None) is not None:
        solver._solve_M = sharded_element_cg(
            solver.M_loc, solver.cell_dofs, solver.constraints, mesh)
    return solver


def _padded_layout(solver, mesh: CellMesh):
    """The JAX package's padded [u .. pad | p .. pad] layout
    (openifem_tpu/parallel/shard.py:219-292) with this rank's cell
    tables."""
    d = solver.dim
    n_u, n_p = solver.n_u, solver.n_p
    # the u block keeps the node-block layout: whole nodes
    n_u_pad = _pad(n_u, math.lcm(mesh.size, d))
    n_p_pad = _pad(n_p, mesh.size)
    n_pad = n_u_pad + n_p_pad
    shift = n_u_pad - n_u
    zc = solver.zero_constraints
    dev = solver.device

    def ins_vec(vec, fill):
        v = _np(vec)
        return np.concatenate([
            v[:n_u], np.full(n_u_pad - n_u, fill, dtype=v.dtype),
            v[n_u:], np.full(n_p_pad - n_p, fill, dtype=v.dtype)])

    hidx = _np(zc.hang_idx)
    K = hidx.shape[1]
    hidx = np.where(hidx >= n_u, hidx + shift, hidx)
    pad_u_rows = np.tile(np.arange(n_u, n_u_pad, dtype=hidx.dtype)[:, None],
                         (1, K))
    pad_p_rows = np.tile(np.arange(n_u_pad + n_p, n_pad,
                                   dtype=hidx.dtype)[:, None], (1, K))
    hw = _np(zc.hang_w)
    pad_w = np.zeros((1, K))
    pad_w[0, 0] = 1.0
    cons_pad = Constraints(
        n_pad, np.concatenate([hidx[:n_u], pad_u_rows, hidx[n_u:],
                               pad_p_rows]),
        np.concatenate([hw[:n_u], np.tile(pad_w, (n_u_pad - n_u, 1)),
                        hw[n_u:], np.tile(pad_w, (n_p_pad - n_p, 1))]),
        ins_vec(zc.hanging, False), ins_vec(zc.dirichlet, True),
        ins_vec(zc.dirichlet_values, 0.0), device=dev)

    cd = solver.cell_dofs
    cd = torch.where(cd >= n_u, cd + shift, cd)

    def pad_diag(v, n_new):
        out = torch.ones(n_new, dtype=v.dtype, device=v.device)
        out[:v.shape[0]] = v
        return out

    first, end, per = cell_range(solver.mesh.n_cells, mesh)
    # InsIM's mass blocks and diagonals (the SUPG family has none)
    mass = dict(Mp_loc=_rank_cells(solver.Mp_loc, mesh),
                Mu_diag=pad_diag(solver.Mu_diag, n_u_pad),
                Mp_diag=pad_diag(solver.Mp_diag, n_p_pad)) \
        if hasattr(solver, "Mp_loc") else {}
    lay = types.SimpleNamespace(
        n_u=n_u, n_p=n_p, n_u_pad=n_u_pad, n_p_pad=n_p_pad, n_pad=n_pad,
        cons_pad=cons_pad, n_cells=per, n_zero=per - (end - first),
        ucons_pad=_pad_constraints(solver._u_cons_of(zc), n_u_pad),
        pcons_pad=_pad_constraints(solver.p_constraints, n_p_pad),
        cell_dofs=_rank_cells(cd, mesh, fill=n_pad - 1),
        cell_dofs_u=_rank_cells(solver.cell_dofs_u, mesh,
                                fill=n_u_pad - 1),
        cell_dofs_p=_rank_cells(solver.cell_dofs_p, mesh,
                                fill=n_p_pad - 1),
        # pad cells carry zero blocks, so any fill node is safe
        cell_nodes_u=_rank_cells(solver.cell_nodes_u, mesh,
                                 fill=n_u_pad // d - 1),
        mass=mass, view=_rank_view(solver, mesh, first, end))
    return lay


def _kernel_tables(solver, lay):
    """The rank's padded tables in the form of a solver's (what a kernel
    check reads)."""
    return types.SimpleNamespace(
        dim=solver.dim, nlu=solver.nlu, nu_loc=solver.nu_loc,
        nlp=solver.nlp, n_u=lay.n_u_pad, n_p=lay.n_p_pad, n_dofs=lay.n_pad,
        cell_dofs=lay.cell_dofs, cell_dofs_u=lay.cell_dofs_u,
        cell_dofs_p=lay.cell_dofs_p, cell_nodes_u=lay.cell_nodes_u,
        mesh=types.SimpleNamespace(n_cells=lay.n_cells))


def _padded_newton(solver, mesh: CellMesh, outer_atol, what: str):
    """One Newton iteration on the padded layout: own-cell assembly, the
    outer Taylor-Hood apply on the rank's cells plus one all-reduce, the
    solver's own preconditioner on its padded rank view (the solver's
    knobs, the rank's padded tables), FGMRES on whole padded vectors."""
    _refuse_whole_cell_branches(solver, what)
    lay = _padded_layout(solver, mesh)
    coll = mesh.coll
    d, nlu = solver.dim, solver.nu_loc // solver.dim
    n_u, n_p, n_u_pad, n_p_pad = lay.n_u, lay.n_p, lay.n_u_pad, lay.n_p_pad
    padded = _RankView(
        solver, n_u=n_u_pad, n_p=n_p_pad, cell_dofs=lay.cell_dofs,
        cell_dofs_u=lay.cell_dofs_u, cell_dofs_p=lay.cell_dofs_p,
        cell_nodes_u=lay.cell_nodes_u, cell_reduce=coll.all_reduce_sum,
        _u_stencil=None, _sys_stencil=None, **lay.mass)
    zc = solver.zero_constraints

    def newton(eval_pt, present, *fields):
        A_loc, rhs = lay.view._assemble(eval_pt, present, *fields)
        if lay.n_zero:
            A_loc = torch.cat([A_loc, A_loc.new_zeros(
                (lay.n_zero,) + tuple(A_loc.shape[1:]))])
        b = zc.condense_rhs(rhs)
        b_pad = b.new_zeros(lay.n_pad)
        b_pad[:n_u] = b[:n_u]
        b_pad[n_u_pad:n_u_pad + n_p] = b[n_u:]
        res_norm = torch.linalg.vector_norm(b_pad).item()

        def apply_A(x):
            return coll.all_reduce_sum(element_matvec_taylor_hood(
                A_loc, lay.cell_nodes_u, lay.cell_dofs_p, nlu, d, n_u_pad,
                n_p_pad, x, cell_dofs=lay.cell_dofs))
        op = lay.cons_pad.wrap_operator(apply_A)
        precond = padded._make_preconditioner(A_loc, lay.ucons_pad,
                                              lay.pcons_pad)
        res = fgmres(op, b_pad, M=precond, atol=outer_atol(res_norm),
                     restart=solver.outer_restart,
                     max_restarts=solver.outer_max_restarts)
        du = torch.cat([res.x[:n_u], res.x[n_u_pad:n_u_pad + n_p]])
        return zc.distribute(du), res_norm, res.iters, res.residual
    newton.tables = _kernel_tables(solver, lay)
    return newton


def sharded_insim_newton(solver, mesh: CellMesh):
    """One Newton iteration of a set-up InsIM over the mesh's ranks, on
    the JAX package's padded [u | p] layout with InsIM's block-Schur
    preconditioner on the padded rank view (the element branch of the
    A-solve, with the solver's own knobs; reference distributed solve:
    source/mpi_insim.cpp:364-395).  Returns fn(eval_pt, present,
    indicator, fsi_acc, fsi_stress, fsi_acc_nodal) -> (du, res_norm,
    iters, residual) on the original layout, solving the same condensed
    system to the same tolerance as solver._newton_iter_impl."""
    return _padded_newton(solver, mesh, lambda rn: max(1e-8 * rn, 1e-10),
                          "sharded_insim_newton")


def make_sharded_stepper(solver, mesh: CellMesh):
    """Time stepping of InsIM with every Newton iteration sharded (see
    sharded_insim_newton): per step, Newton from the present solution
    while res / res0 > fluid_tolerance, res > 1e-11 and fewer than
    fluid_max_iterations iterations.  Returns fn(present, n_steps) ->
    (present, max_rel_res, max_newton_iters) on the original layout: the
    worst final relative residual and the largest iteration count over the
    window."""
    newton = sharded_insim_newton(solver, mesh)
    tol = solver.params.fluid_tolerance
    max_it = solver.params.fluid_max_iterations

    def newton_once(eval_pt, present):
        du, rn, _, _ = newton(eval_pt, present, solver.indicator,
                              solver.fsi_acceleration,
                              solver.fsi_stress_cell, solver.fsi_acc_nodal)
        return eval_pt + du, rn

    def one_step(present):
        eval_pt, res0 = newton_once(present, present)
        it, res = 1, res0
        while res / max(res0, 1e-300) > tol and res > 1e-11 and it < max_it:
            eval_pt, res = newton_once(eval_pt, present)
            it += 1
        rel = res / max(res0, 1e-300) if res0 > 1e-11 else 0.0
        return eval_pt, rel, it

    def run_n(present, n_steps):
        worst_rel, worst_it = 0.0, 0
        for _ in range(int(n_steps)):
            present, rel, it = one_step(present)
            worst_rel, worst_it = max(worst_rel, rel), max(worst_it, it)
        return present, worst_rel, worst_it
    run_n.tables = newton.tables
    return run_n


def sharded_supg_newton(solver, mesh: CellMesh):
    """One Newton iteration of a set-up SUPG-family solver (SUPGInsIM /
    SCnsIM / SerialSCnsIM) over the mesh's ranks, as
    sharded_insim_newton: padded [u | p] layout, the Washio
    incomplete-Schur (Tpp) preconditioner on the padded rank view (node-block
    pieces, the B2pp diagonal; reference distributed solve:
    source/mpi_supg_solver.cpp:296-328).  Returns fn(eval_pt, present,
    indicator, fsi_acc_nodal, fsi_stress_nodal, stress_nodal, eddy_nu) ->
    (du, res_norm, iters, residual)."""
    return _padded_newton(solver, mesh, lambda rn: solver.outer_rtol * rn,
                          "sharded_supg_newton")


# ----------------------------------------------------------------------
# Plane-sharded stencil
# ----------------------------------------------------------------------

class ShardedStencil:
    """Plane-sharded structured-patch stencil apply.

    Partitions a single-brick StencilOperator (la/stencil.py) along the
    FIRST grid axis of the bordered brick: each rank owns a contiguous
    chunk of `cx` node planes (plane = all slots sharing the axis-0
    coordinate, R = prod(Gp[1:]) slots each) plus a k-plane halo per side,
    exchanged with its neighbours once per matvec (2*k*R*d values per
    inner boundary; the reference partitions exactly this cost through
    PETSc's owned/ghost rows, source/mpi_fluid_solver.cpp:116-162).

    The apply is the replicated one on a (cx + 2k)-plane buffer: the
    flattened offsets and the F-guard do not depend on the plane count
    (the axis-0 stride is R).  W rows on halo planes are zero, so every
    output plane has one owner.  Vectors are (d, cx, R) tensors on each
    rank; Krylov dots go through the mesh's all-reduce.  Requires a
    merged single-brick grid (no shared nodes)."""

    def __init__(self, st, mesh: CellMesh):
        if len(st._groups) != 1 or st._groups[0].n_b != 1 \
                or st.n_shared != 0:
            raise ValueError("sharded stencil needs a merged single-brick "
                             "grid (no shared nodes)")
        g = st._groups[0]
        self.st, self.mesh, self.coll = st, mesh, mesh.coll
        self.k, self.S, self.dim = st.k, st.S, st.dim
        self.P0 = g.Gp[0]                    # bordered planes, axis 0
        self.R = g.M // self.P0              # slots per plane
        self.P_pad = _pad(self.P0, mesh.size)
        self.cx = self.P_pad // mesh.size
        if self.cx < st.k:
            raise ValueError("chunk thinner than the stencil halo")
        self.p0 = mesh.rank * self.cx        # first owned plane
        self.strides = g.strides             # plane-count-independent
        self.F = g.F

    # -- layout maps (flat global <-> this rank's plane chunk) ----------
    def _chunk(self, X):
        """(d, P0, R) -> this rank's (d, cx, R), pad planes zero."""
        X = torch.nn.functional.pad(X, (0, 0, 0, self.P_pad - self.P0))
        return X[:, self.p0:self.p0 + self.cx].contiguous()

    def spread(self, x):
        """Global flat (n_nodes*d,) -> this rank's (d, cx, R)."""
        return self._chunk(self.st.spread(x).reshape(-1, self.P0, self.R))

    def spread_mask(self, mask):
        return self.spread(mask)

    def unspread(self, X):
        """(d, cx, R) chunks of every rank -> global flat (all-gather)."""
        Xf = self.coll.all_gather_cat(X, dim=1)[:, :self.P0]
        return self.st.unspread(Xf.reshape(X.shape[0], -1))

    def weight(self, dtype=torch.float32, d=None):
        """Ownership weights of this rank's chunk (pad planes 0)."""
        d = self.st.d if d is None else d
        return self._chunk(self.st.weight(dtype, d=d).reshape(d, self.P0,
                                                              self.R))

    def shard_weights(self, Ws):
        """Stencil tensors from st.build_weights -> this rank's planes
        with k zero planes on each side, flat per plane buffer:
        (S^dim, d_out, d_in, (cx + 2k) * R)."""
        (W,) = Ws                            # single group, n_b == 1
        Sd, do, di = W.shape[0], W.shape[1], W.shape[2]
        W = W.reshape(Sd * do * di, self.P0, self.R)
        W = self._chunk(W)
        W = torch.nn.functional.pad(W, (0, 0, self.k, self.k))
        return W.reshape(Sd, do, di, -1)

    # -- apply ------------------------------------------------------------
    def matvec(self, W, X):
        """y = A x on (d, cx, R) chunks; W from shard_weights."""
        k, dim, S, F = self.k, self.dim, self.S, self.F
        di = X.shape[0]
        Sd, do, _, Ml = W.shape
        from_prev, from_next = self.coll.neighbour_exchange(
            X[:, :k], X[:, -k:])
        Xb = torch.cat([from_prev, X, from_next], dim=1).reshape(di, Ml)
        Xp = torch.nn.functional.pad(Xb, (F, F))
        win = Xp.as_strided((di,) + (S,) * dim + (Ml,),
                            (Xp.stride(0),) + self.strides + (1,))
        win = win.permute(tuple(range(1, 1 + dim)) + (0, 1 + dim))
        Wv = W.reshape((S,) * dim + (do, di, Ml))
        y = (Wv * win.unsqueeze(dim)).reshape(Sd, do, di, Ml).sum(
            dim=0).sum(dim=1)
        return y.reshape(do, self.cx + 2 * k, self.R)[:, k:-k]

    def condensed_matvec(self, W, fixed, X):
        """Constraint-condensed apply (Dirichlet-only meshes): identity
        on fixed rows, fixed columns zeroed."""
        Y = self.matvec(W, torch.where(fixed, 0.0, X))
        return torch.where(fixed, X, Y)


def sharded_stencil_asolve(solver, mesh: CellMesh):
    """Plane-sharded inner A-block solve for an InsIM-family solver whose
    mesh merged into a single stencil brick: element blocks -> stencil
    tensors -> weighted Jacobi FGMRES on the ranks' plane chunks.
    Returns solve(Auu, b, atol) -> SolveResult on the flat global layout
    (Auu and b whole on every rank), solving the same condensed system as
    the replicated stencil path; solve.sharded is the ShardedStencil."""
    st = solver._u_stencil
    sst = ShardedStencil(st, mesh)
    ucons = solver.u_constraints
    d, nlu = solver.dim, solver.nlu
    n_c = int(solver.mesh.n_cells)

    def solve(Auu, b, atol):
        W = sst.shard_weights(
            st.build_weights(Auu.reshape(n_c, nlu, d, nlu, d)))
        fix = sst.spread_mask(ucons.fixed)
        diag = torch.where(ucons.fixed, 1.0, element_diag(
            Auu, solver.cell_dofs_u, solver.n_u))
        dinv = sst.spread(torch.where(diag != 0, 1.0 / diag, 1.0))
        res = fgmres(lambda x: sst.condensed_matvec(W, fix, x),
                     sst.spread(b), M=lambda r: r * dinv, atol=atol,
                     restart=solver.a_inner_restart,
                     max_restarts=solver.a_inner_restarts,
                     weight=sst.weight(b.dtype),
                     reduce=mesh.coll.all_reduce_sum)
        return SolveResult(sst.unspread(res.x), res.iters, res.residual)
    solve.sharded = sst
    return solve
