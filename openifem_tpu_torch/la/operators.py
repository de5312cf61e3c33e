"""Matrix-free element-block operators.

Counterpart of openifem_tpu/la/operators.py, with the same signatures and
layouts.  Each matvec layout has a plain PyTorch version (`*_plain`:
index_select -> einsum -> index_add_) and a dispatching entry point of
the JAX name: a CUDA tensor goes to the hand-written kernel
(la/cuda_ops.py, csrc/element_matvec.cu), a CPU tensor to the plain
version.  On a CUDA tensor the kernel runs or the call raises; it never
falls back to the plain version.  The kernel reads the gather plan of
`make_gather_plan`, which cuda_ops builds once per index table.

Every other scatter-add of the port goes through `index_sum` /
`add_at` (and `dense_sum` for dense builds), dispatched the same
way: a CPU tensor takes index_add_, which sums in index order there; a
CUDA tensor takes a planned sum, a gather through the table's sum plan
(`sum_plan`, built once per table) and a row sum in a fixed order, as the
JAX package's make_gather_plan / element_matvec_gather do.  The card's
index_add_ sums with atomics in whatever order they land, so two runs of
the same input would round differently; the planned sum has no atomics
and writes each output once, so the card repeats itself to the bit.
"""

from __future__ import annotations

import math

import torch
from torch.overrides import TorchFunctionMode

from ..config import device as _device
from ..config import index_dtype
from . import cuda_ops


# sum plans built (one per index table and output count)
sum_plan_builds = 0


def _on_card(t):
    """Whether t takes the card's route: the kernel and the planned sums
    (the tests run that route on the CPU by replacing this)."""
    return t.is_cuda


def make_sum_plan(idx, n_out: int, live=None):
    """The plan of a deterministic scatter-add of the flat positions of
    idx (any shape, entries in [0, n_out)) into n_out outputs:
    (targets, plan).  targets (n_t,) int64 lists in increasing order the
    outputs idx reaches, or is None when it reaches all n_out; plan is
    make_gather_plan of idx renumbered over them, (n_t, K) int32: row t
    lists in increasing order the flat positions of idx that hold
    targets[t], padded with the sentinel idx.numel().  Sorts are stable,
    so the plan of a table is the same on every build.

    live: a bool mask of idx's shape, or None.  Entries where it is False
    stay out of the plan: pass it for slots whose values are always exact
    zeros (the padding of a fixed-width neighbour table, which would
    otherwise pile onto a few outputs and widen K for all)."""
    flat = idx.reshape(-1).long()
    if flat.numel() >= 2 ** 31:
        raise ValueError("index table has more than 2**31 entries")
    if flat.numel() and (int(flat.min()) < 0 or int(flat.max()) >= n_out):
        raise ValueError(f"index table has entries outside [0, {n_out})")
    pos = None
    if live is not None:
        pos = torch.nonzero(live.reshape(-1)).reshape(-1)
        flat = flat[pos]
    targets, local = torch.unique(flat, sorted=True, return_inverse=True)
    plan = make_gather_plan(local, targets.numel())
    if pos is not None:
        # positions in idx; the sentinel becomes idx.numel()
        pos = torch.cat([pos, pos.new_full((1,), idx.numel())])
        plan = pos[plan.long()].to(torch.int32)
    return (None if targets.numel() == n_out else targets), plan


def _cached_plan(table, key, build, others=()):
    def make():
        global sum_plan_builds
        sum_plan_builds += 1
        return build()
    return cuda_ops._cached(table, ("sum",) + key, make, others)


def sum_plan(idx, n_out: int, live=None):
    """make_sum_plan(idx, n_out, live), built once per table: cached on
    idx and keyed by its version counter (and live's; cuda_ops._cached),
    so a table changed in place, or a new table, gets a new plan;
    `sum_plan_builds` counts the builds.  Pass the solver's persistent
    table, not a view made per call (a view is a new tensor, and its plan
    is built on every call)."""
    return _cached_plan(idx, (n_out,),
                        lambda: make_sum_plan(idx, n_out, live),
                        () if live is None else (live,))


def dense_sum_plan(row_dofs, col_dofs, n_rows: int, n_cols: int):
    """sum_plan of the flat positions row * n_cols + col of element blocks
    with dof tables row_dofs (n_c, nl_r) and col_dofs (n_c, nl_c) in a
    dense (n_rows, n_cols) matrix: it covers the blocks' distinct
    positions, not the matrix.  Cached on row_dofs while both tables are
    unchanged."""
    def build():
        flat = (row_dofs.long()[:, :, None] * n_cols +
                col_dofs.long()[:, None, :])
        return make_sum_plan(flat, n_rows * n_cols)
    return _cached_plan(row_dofs, ("dense", n_rows, n_cols), build,
                        (col_dofs,))


def dense_sum(blocks, row_dofs, col_dofs, n_rows: int, n_cols: int):
    """The dense (n_rows, n_cols) matrix of element blocks (n_c, nl_r,
    nl_c) with dof tables row_dofs and col_dofs (duplicates accumulate).
    On a CUDA tensor: the planned sum over the blocks' distinct positions
    (dense_sum_plan), written once into a zero matrix."""
    vals = blocks.reshape(-1)
    if not _on_card(vals):
        M = vals.new_zeros((n_rows, n_cols))
        flat = (row_dofs.long()[:, :, None] * n_cols +
                col_dofs.long()[:, None, :])
        M.view(-1).index_add_(0, flat.reshape(-1), vals)
        return M
    targets, plan = dense_sum_plan(row_dofs, col_dofs, n_rows, n_cols)
    s = planned_sum(vals, plan)
    if targets is None:
        return s.view(n_rows, n_cols)
    M = vals.new_zeros((n_rows, n_cols))
    M.view(-1).index_put_((targets,), s)
    return M


def planned_sum(vals, plan, dim: int = 0):
    """vals with its dim `dim` summed through the plan, to n_t entries:
    entry t is the sum over k of the slices vals[plan[t, k]] (the
    sentinel reads a zero slice), a gather and a sum in a fixed order,
    with no atomics.  The dims after `dim` are gathered as one row."""
    lead, rest = tuple(vals.shape[:dim]), tuple(vals.shape[dim + 1:])
    v = vals.reshape(lead + (vals.shape[dim], math.prod(rest)))
    pad = torch.cat([v, v.new_zeros(lead + (1, v.shape[-1]))], dim=dim)
    g = pad.index_select(dim, plan.reshape(-1))
    return g.view(lead + tuple(plan.shape) + (v.shape[-1],)).sum(
        dim=dim + 1).view(lead + (plan.shape[0],) + rest)


def add_at(out, idx, vals, dim: int = 0, live=None):
    """out.index_add_(dim, idx.reshape(-1), vals) in place; returns out.
    vals holds idx.shape where out has dim (e.g. idx (n_c, nl) and vals
    (n_c, nl, d) for out (n, d)).  On a CUDA tensor: the planned sum of
    idx's sum plan (live: make_sum_plan's; the CPU adds every entry),
    added to the outputs it reaches."""
    v = vals.reshape(out.shape[:dim] + (idx.numel(),) + out.shape[dim + 1:])
    if not _on_card(out):
        return out.index_add_(dim, idx.reshape(-1), v)
    targets, plan = sum_plan(idx, out.shape[dim], live)
    s = planned_sum(v, plan, dim)
    if targets is None:
        return out.add_(s)
    at = (slice(None),) * dim + (targets,)
    out[at] = out[at] + s
    return out


def index_sum(n_out: int, idx, vals, live=None):
    """torch.zeros(n_out, *rest).index_add_(0, idx.reshape(-1), vals),
    with vals of shape idx.shape + rest: on a CUDA tensor the planned
    sum (live: make_sum_plan's), written once into each output."""
    rest = tuple(vals.shape[idx.dim():])
    if not _on_card(vals):
        return add_at(vals.new_zeros((n_out,) + rest), idx, vals)
    targets, plan = sum_plan(idx, n_out, live)
    s = planned_sum(vals.reshape((idx.numel(),) + rest), plan)
    if targets is None:
        return s
    return vals.new_zeros((n_out,) + rest).index_put_((targets,), s)


def scatter_add(n_dofs: int, idx, vals):
    """y[idx] += vals over flattened index/value arrays."""
    return index_sum(n_dofs, idx, vals.reshape(idx.shape))


class AtomicScatterGuard(TorchFunctionMode):
    """Inside it, a floating-point scatter-add on a tensor of
    `device_type` raises: index_add(_), index_put(_) / put(_) with
    accumulate=True, scatter_add(_), and scatter_reduce(_) with "sum" or
    "mean".  On the card these sum with atomics in no fixed order; the
    port sums through plans there, and runs under this guard to show it.
    (Order-free reductions such as scatter_reduce "amax" pass.)"""

    # name: (position, keyword, values that make the call atomic), or
    # None when every call is
    _WATCHED = {"index_add": None, "index_add_": None, "scatter_add": None,
                "scatter_add_": None,
                "index_put": (3, "accumulate", (True,)),
                "index_put_": (3, "accumulate", (True,)),
                "put": (3, "accumulate", (True,)),
                "put_": (3, "accumulate", (True,)),
                "scatter_reduce": (4, "reduce", ("sum", "mean")),
                "scatter_reduce_": (4, "reduce", ("sum", "mean"))}

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", None)
        if name in self._WATCHED:
            self._check(name, args, kwargs)
        return func(*args, **kwargs)

    def _check(self, name, args, kwargs):
        t = args[0] if args else None
        if not (isinstance(t, torch.Tensor) and t.is_floating_point()
                and t.device.type == self.device_type):
            return
        rule = self._WATCHED[name]
        if rule is not None:
            pos, key, atomic = rule
            value = args[pos] if len(args) > pos else kwargs.get(key)
            if value not in atomic:
                return
        raise RuntimeError(f"atomic scatter-add {name} on a "
                           f"{self.device_type} tensor: sum through "
                           "la/operators.py's plans")


def _strides(A, name, checks):
    """Raise unless A's strides satisfy `checks` ((dim, expected) pairs:
    the kernel reads columns contiguously and node/component rows at a
    fixed pitch)."""
    for dim, want in checks:
        if A.stride(dim) != want:
            raise ValueError(
                f"{name}: A has strides {A.stride()}; the CUDA kernel "
                f"needs stride {want} on dim {dim}")


# -- scalar layout ------------------------------------------------------
def element_matvec_plain(A_loc, cell_dofs, n_dofs: int, x):
    xl = x[cell_dofs]
    yl = torch.einsum("cij,cj->ci", A_loc, xl)
    y = torch.zeros(n_dofs, dtype=x.dtype, device=x.device)
    return y.index_add_(0, cell_dofs.reshape(-1), yl.reshape(-1))


def element_matvec(A_loc, cell_dofs, n_dofs: int, x):
    """y = A x with A given by element blocks.

    A_loc: (n_c, nl, nl); cell_dofs: (n_c, nl) int; x: (n_dofs,)."""
    if not _on_card(x):
        return element_matvec_plain(A_loc, cell_dofs, n_dofs, x)
    _strides(A_loc, "element_matvec", [(2, 1)])
    nl = A_loc.shape[1]
    return cuda_ops.launch("element_matvec", A_loc, A_loc.stride(0),
                           A_loc.stride(1), cell_dofs, cell_dofs, n_dofs,
                           x, nl, nl)


def element_matvec_rect_plain(A_loc, row_dofs, col_dofs, n_rows: int, x):
    xl = x[col_dofs]
    yl = torch.einsum("cij,cj->ci", A_loc, xl)
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    return y.index_add_(0, row_dofs.reshape(-1), yl.reshape(-1))


def element_matvec_rect(A_loc, row_dofs, col_dofs, n_rows: int, x):
    """Rectangular block apply: rows/cols indexed by different dof maps."""
    if not _on_card(x):
        return element_matvec_rect_plain(A_loc, row_dofs, col_dofs, n_rows,
                                         x)
    _strides(A_loc, "element_matvec_rect", [(2, 1)])
    return cuda_ops.launch("element_matvec_rect", A_loc, A_loc.stride(0),
                           A_loc.stride(1), row_dofs, col_dofs, n_rows, x,
                           A_loc.shape[1], A_loc.shape[2])


# -- node-block layouts -------------------------------------------------
def element_matvec_nodeblock_plain(Ab, cell_nodes, n_nodes: int, x):
    d = Ab.shape[2]
    xl = x.reshape(-1, d)[cell_nodes]                # (n_c, nl, d)
    yl = torch.einsum("ciajb,cjb->cia", Ab, xl)
    y = torch.zeros((n_nodes, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, cell_nodes.reshape(-1), yl.reshape(-1, d))
    return y.reshape(-1)


def element_matvec_nodeblock(Ab, cell_nodes, n_nodes: int, x):
    """y = A x for vector-valued blocks in node-block layout.

    Ab: (n_c, nl, d, nl, d) element blocks; cell_nodes: (n_c, nl) NODE
    indices; x: (n_nodes*d,) interleaved [node0_x, node0_y, ...]."""
    if not _on_card(x):
        return element_matvec_nodeblock_plain(Ab, cell_nodes, n_nodes, x)
    n_c, nl, d = Ab.shape[:3]
    _strides(Ab, "element_matvec_nodeblock",
             [(4, 1), (3, d), (1, d * Ab.stride(2))])
    return cuda_ops.launch("element_matvec_nodeblock", Ab, Ab.stride(0),
                           Ab.stride(2), cell_nodes, cell_nodes,
                           n_nodes * d, x, nl * d, nl * d, d, d)


def element_matvec_p_to_u_nodeblock_plain(Aup_b, u_nodes, p_dofs,
                                          n_u_nodes: int, xp):
    d = Aup_b.shape[2]
    ylu = torch.einsum("ciak,ck->cia", Aup_b, xp[p_dofs])
    y = torch.zeros((n_u_nodes, d), dtype=xp.dtype, device=xp.device)
    y.index_add_(0, u_nodes.reshape(-1), ylu.reshape(-1, d))
    return y.reshape(-1)


def element_matvec_p_to_u_nodeblock(Aup_b, u_nodes, p_dofs,
                                    n_u_nodes: int, xp):
    """y_u = Aup x_p with the velocity side in node-block layout.
    Aup_b: (n_c, nlu, d, nlp); returns the flat interleaved u vector."""
    if not _on_card(xp):
        return element_matvec_p_to_u_nodeblock_plain(Aup_b, u_nodes, p_dofs,
                                                     n_u_nodes, xp)
    n_c, nlu, d, nlp = Aup_b.shape
    _strides(Aup_b, "element_matvec_p_to_u_nodeblock",
             [(3, 1), (1, d * Aup_b.stride(2))])
    return cuda_ops.launch("element_matvec_p_to_u_nodeblock", Aup_b,
                           Aup_b.stride(0), Aup_b.stride(2), u_nodes, p_dofs,
                           n_u_nodes * d, xp, nlu * d, nlp, d, 1)


def element_matvec_u_to_p_nodeblock_plain(Apu_b, u_nodes, p_dofs, n_p: int,
                                          xu):
    d = Apu_b.shape[3]
    xlu = xu.reshape(-1, d)[u_nodes]
    ylp = torch.einsum("ckjb,cjb->ck", Apu_b, xlu)
    y = torch.zeros(n_p, dtype=xu.dtype, device=xu.device)
    return y.index_add_(0, p_dofs.reshape(-1), ylp.reshape(-1))


def element_matvec_u_to_p_nodeblock(Apu_b, u_nodes, p_dofs, n_p: int, xu):
    """y_p = Apu x_u with the velocity side in node-block layout.
    Apu_b: (n_c, nlp, nlu, d); xu: flat interleaved u vector."""
    if not _on_card(xu):
        return element_matvec_u_to_p_nodeblock_plain(Apu_b, u_nodes, p_dofs,
                                                     n_p, xu)
    n_c, nlp, nlu, d = Apu_b.shape
    _strides(Apu_b, "element_matvec_u_to_p_nodeblock", [(3, 1), (2, d)])
    return cuda_ops.launch("element_matvec_u_to_p_nodeblock", Apu_b,
                           Apu_b.stride(0), Apu_b.stride(1), p_dofs, u_nodes,
                           n_p, xu, nlp, nlu * d, 1, d)


# -- coupled Taylor-Hood layout -----------------------------------------
def element_matvec_taylor_hood_plain(A_loc, u_nodes, p_dofs, nlu: int,
                                     d: int, n_u: int, n_p: int, x):
    n_c = A_loc.shape[0]
    nu = nlu * d
    Auu = A_loc[:, :nu, :nu].reshape(n_c, nlu, d, nlu, d)
    Aup = A_loc[:, :nu, nu:].reshape(n_c, nlu, d, -1)
    Apu = A_loc[:, nu:, :nu].reshape(n_c, -1, nlu, d)
    App = A_loc[:, nu:, nu:]

    xlu = x[:n_u].reshape(-1, d)[u_nodes]            # (n_c, nlu, d)
    xlp = x[n_u:][p_dofs]                            # (n_c, nlp)
    ylu = (torch.einsum("ciajb,cjb->cia", Auu, xlu) +
           torch.einsum("ciak,ck->cia", Aup, xlp))
    ylp = (torch.einsum("ckjb,cjb->ck", Apu, xlu) +
           torch.einsum("ckl,cl->ck", App, xlp))
    yu = torch.zeros((n_u // d, d), dtype=x.dtype, device=x.device)
    yu.index_add_(0, u_nodes.reshape(-1), ylu.reshape(-1, d))
    yp = torch.zeros(n_p, dtype=x.dtype, device=x.device)
    yp.index_add_(0, p_dofs.reshape(-1), ylp.reshape(-1))
    return torch.cat([yu.reshape(-1), yp])


def element_matvec_taylor_hood(A_loc, u_nodes, p_dofs, nlu: int, d: int,
                               n_u: int, n_p: int, x, cell_dofs=None):
    """Full coupled [u | p] matvec with the velocity part in node-block
    layout.  A_loc: (n_c, nlu*d + nlp, nlu*d + nlp) with the local
    velocity dofs interleaved (node-major, component-minor) followed by
    the pressure dofs; u_nodes: (n_c, nlu) velocity NODE indices;
    p_dofs: (n_c, nlp) pressure dof indices (0-based in the p block);
    x: (n_u + n_p,) global [u | p] vector.

    cell_dofs: the system dof table (n_c, nlu*d + nlp), equal to
    [u_nodes*d + component (interleaved) | p_dofs + n_u].  The CUDA path
    needs it: it runs the whole coupled apply as one scalar-layout launch
    over that table."""
    if not _on_card(x):
        return element_matvec_taylor_hood_plain(A_loc, u_nodes, p_dofs, nlu,
                                                d, n_u, n_p, x)
    if cell_dofs is None:
        raise ValueError("element_matvec_taylor_hood on CUDA needs the "
                         "system dof table (cell_dofs=)")
    _strides(A_loc, "element_matvec_taylor_hood", [(2, 1)])
    nl = A_loc.shape[1]
    return cuda_ops.launch("element_matvec_taylor_hood", A_loc,
                           A_loc.stride(0), A_loc.stride(1), cell_dofs,
                           cell_dofs, n_u + n_p, x, nl, nl)


def make_gather_plan(cell_dofs, n_dofs: int):
    """Per-dof incidence table turning the matvec scatter-add into a
    static-shape gather + sum (the JAX package's transpose layout).

    Returns (n_dofs, K) int32, on cell_dofs' device: row e lists, in
    increasing order, the flat (cell * nl + local) positions whose dof is
    e, padded at the end with the sentinel n_c * nl, the index of a zero
    slot appended to the flattened (n_c * nl,) local results.  K is the
    largest number of incidences of a dof (1 when the table is empty).
    The CUDA kernel walks these rows (la/cuda_ops.py)."""
    cd = cell_dofs.reshape(-1).long()
    n_flat = cd.numel()
    order = torch.argsort(cd, stable=True)
    sorted_dofs = cd[order]
    counts = torch.bincount(cd, minlength=n_dofs)
    K = int(counts.max()) if n_flat else 1
    inc = torch.full((n_dofs, K), n_flat, dtype=torch.int64,
                     device=cd.device)
    starts = torch.zeros(n_dofs + 1, dtype=torch.int64, device=cd.device)
    torch.cumsum(counts, 0, out=starts[1:])
    ar = torch.arange(n_flat, device=cd.device)
    inc[sorted_dofs, ar - starts[sorted_dofs]] = order
    return inc.to(torch.int32)


def element_matvec_gather(A_loc, cell_dofs, plan, x):
    """y = A x via the gather plan (same result as element_matvec)."""
    return element_matvec_rect_gather(A_loc, cell_dofs, plan, x)


def element_matvec_rect_gather(A_loc, col_dofs, row_plan, x):
    """Rectangular block apply via a row-dof gather plan."""
    yl = torch.einsum("cij,cj->ci", A_loc, x[col_dofs])
    ylp = torch.cat([yl.reshape(-1), yl.new_zeros(1)])
    return ylp[row_plan.long()].sum(dim=1)


def element_diag(A_loc, cell_dofs, n_dofs: int):
    return index_sum(n_dofs, cell_dofs,
                     torch.diagonal(A_loc, dim1=1, dim2=2))


class ElementOperator:
    """Bundles a dof map with element_matvec and element_diag (the JAX
    package's la/operators.py::ElementOperator): the blocks are given per
    call."""

    def __init__(self, cell_dofs, n_dofs: int, device=None):
        self.cell_dofs = torch.as_tensor(cell_dofs, dtype=index_dtype,
                                         device=_device(device))
        self.n_dofs = n_dofs

    def matvec(self, A_loc, x):
        return element_matvec(A_loc, self.cell_dofs, self.n_dofs, x)

    def diag(self, A_loc):
        return element_diag(A_loc, self.cell_dofs, self.n_dofs)
