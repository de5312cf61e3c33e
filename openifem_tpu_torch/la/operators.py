"""Matrix-free element-block operators.

Counterpart of openifem_tpu/la/operators.py, with the same signatures and
layouts.  Each matvec layout has a plain PyTorch version (`*_plain`:
index_select -> einsum -> index_add_) and a dispatching entry point of
the JAX name: a CUDA tensor goes to the hand-written kernel
(la/cuda_ops.py, csrc/element_matvec.cu), a CPU tensor to the plain
version.  On a CUDA tensor the kernel runs or the call raises; it never
falls back to the plain version.  The kernel reads the gather plan of
`make_gather_plan`, which cuda_ops builds once per index table.
"""

from __future__ import annotations

import torch

from . import cuda_ops


def scatter_add(n_dofs: int, idx, vals):
    """y[idx] += vals over flattened index/value arrays."""
    return torch.zeros(n_dofs, dtype=vals.dtype,
                       device=vals.device).index_add_(
        0, idx.reshape(-1), vals.reshape(-1))


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
    return scatter_add(n_dofs, cell_dofs, yl)


def element_matvec(A_loc, cell_dofs, n_dofs: int, x):
    """y = A x with A given by element blocks.

    A_loc: (n_c, nl, nl); cell_dofs: (n_c, nl) int; x: (n_dofs,)."""
    if not x.is_cuda:
        return element_matvec_plain(A_loc, cell_dofs, n_dofs, x)
    _strides(A_loc, "element_matvec", [(2, 1)])
    nl = A_loc.shape[1]
    return cuda_ops.launch("element_matvec", A_loc, A_loc.stride(0),
                           A_loc.stride(1), cell_dofs, cell_dofs, n_dofs,
                           x, nl, nl)


def element_matvec_rect_plain(A_loc, row_dofs, col_dofs, n_rows: int, x):
    xl = x[col_dofs]
    yl = torch.einsum("cij,cj->ci", A_loc, xl)
    return scatter_add(n_rows, row_dofs, yl)


def element_matvec_rect(A_loc, row_dofs, col_dofs, n_rows: int, x):
    """Rectangular block apply: rows/cols indexed by different dof maps."""
    if not x.is_cuda:
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
    if not x.is_cuda:
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
    if not xp.is_cuda:
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
    return scatter_add(n_p, p_dofs, ylp)


def element_matvec_u_to_p_nodeblock(Apu_b, u_nodes, p_dofs, n_p: int, xu):
    """y_p = Apu x_u with the velocity side in node-block layout.
    Apu_b: (n_c, nlp, nlu, d); xu: flat interleaved u vector."""
    if not xu.is_cuda:
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
    yp = scatter_add(n_p, p_dofs, ylp)
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
    if not x.is_cuda:
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
    return scatter_add(n_dofs, cell_dofs,
                       torch.diagonal(A_loc, dim1=1, dim2=2))
