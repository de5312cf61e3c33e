"""Structured-patch stencil SpMV on block-structured meshes.

Counterpart of openifem_tpu/la/stencil.py.  Every mesh of the leaflet and
cylinder cases is built from a small coarse quad/hex mesh by global and/or
local refinement, so it decomposes into rectangular BRICKS of same-level
cells, and a Q_k FEM operator restricted to a brick is a dense
(2k+1)^dim-point stencil on a regular node grid.  The stencil apply has no
gather and no scatter: it is S^dim shifted contiguous windows of the
input, each multiplied by a (d x d) coefficient plane.

`PatchGrid.build` tries two decompositions in order:

 1. LATTICE bricks: every cell is an axis-aligned box; cells of each
    refinement level snap onto an integer lattice and are covered
    greedily by maximal rectangular bricks (locally refined, hanging-node
    meshes included: hanging nodes are ordinary slots and the constraint
    projection stays outside the operator).
 2. Z-ORDER patches: uniformly refine_global'd meshes whose cells are not
    axis-aligned; per-coarse-cell m^dim patches decoded from the
    refinement history and verified topologically, with 2D patch
    adjacencies merged into one super-patch.

It returns None when neither applies (the element path remains).  The
host-side construction is numpy, exactly as in the JAX package.

Layout: patch vectors are flat (d, Np_total), Np_total the concatenation
of per-brick zero-BORDERED node grids (border width k per axis), each
flattened x-major.  Bricks of identical shape are batched into one
(n_b, M) group with stencil tensor W[(2k+1)^dim, d, d, n_b, M]:

    y[a, b, m] = sum_{s, c}  W[s, a, c, b, m] * xg[c, b, m + off(s)]

Entries reaching outside a brick are structurally zero in W, so border
reads contribute nothing.  Nodes shared between bricks are stored once
per incident brick and summed by a gather-only combine.  Krylov solves
can run directly in the duplicated layout with OWNERSHIP-WEIGHTED inner
products (la/krylov.py `weight=`), which keeps CG/FGMRES equivalent to the
flat solve in exact arithmetic; on hanging-node meshes `flat_matvec`
drops into Constraints.wrap_operator unchanged.

These applies are plain PyTorch: in the JAX package they are XLA ops, not
a Pallas kernel.
"""

from __future__ import annotations

from itertools import product
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import device as _device


def _lex(idx, k):
    """Local Q_k node index of lattice multi-index (x fastest;
    fe/space.py local numbering)."""
    l = 0
    for t in range(len(idx) - 1, -1, -1):
        l = l * (k + 1) + idx[t]
    return l


def _face_locals(dim):
    """Per axis a: (lower-face local vertex ids, upper-face ids), in the
    same relative z-order so conforming neighbors match elementwise."""
    out = []
    nv = 2 ** dim
    for a in range(dim):
        lo = [i for i in range(nv) if not (i >> a) & 1]
        hi = [i | (1 << a) for i in lo]
        out.append((lo, hi))
    return out


class PatchGrid:
    """Brick/patch decomposition of a block-structured mesh.

    `groups` is a list of int64 arrays, each (n_b, m_1, ..., m_dim):
    n_b bricks of identical cell shape; cell_of[b, i, j(, l)] is the
    fine-cell index at brick coords (i along x, j along y, l along z).
    Built by `build`; returns None when the mesh is not
    brick-structured.
    """

    def __init__(self, dim: int, groups: List[np.ndarray]):
        self.dim = dim
        self.groups = groups
        self.n_patches = sum(int(g.shape[0]) for g in groups)

    # ------------------------------------------------------------------
    @staticmethod
    def _verify(cells, cell_of, dim) -> bool:
        """+axis neighbors in a brick must share the matching face
        vertices elementwise (z-order cell vertex convention)."""
        fl = _face_locals(dim)
        for a in range(dim):
            ax = 1 + a
            sl_lo = [slice(None)] * cell_of.ndim
            sl_hi = [slice(None)] * cell_of.ndim
            sl_lo[ax] = slice(None, -1)
            sl_hi[ax] = slice(1, None)
            A = cell_of[tuple(sl_lo)].reshape(-1)
            B = cell_of[tuple(sl_hi)].reshape(-1)
            lo, hi = fl[a]
            if A.size and not np.array_equal(cells[A][:, hi],
                                             cells[B][:, lo]):
                return False
        return True

    @staticmethod
    def build(mesh) -> Optional["PatchGrid"]:
        if mesh.dim not in (2, 3) or mesh.n_cells == 0:
            return None
        g = PatchGrid._build_lattice(mesh)
        if g is not None:
            return g
        return PatchGrid._build_zorder(mesh)

    # -- lattice bricks (axis-aligned meshes, mixed levels allowed) -----
    @staticmethod
    def _build_lattice(mesh, max_bricks: int = 64) -> Optional["PatchGrid"]:
        dim = mesh.dim
        verts = np.asarray(mesh.vertices)
        cells = np.asarray(mesh.cells)
        cv = verts[cells]                              # (n_c, 2^dim, dim)
        lo = cv[:, 0]
        hi = cv[:, -1]
        size = hi - lo
        scale = float(np.abs(verts).max()) + 1e-30
        if (size <= 1e-12 * scale).any():
            return None
        # axis-aligned check: vertex i coord d = lo[d] or hi[d] by bit d
        bits = np.array([[(i >> d) & 1 for d in range(dim)]
                         for i in range(2 ** dim)], dtype=np.float64)
        expect = lo[:, None, :] + bits[None] * size[:, None, :]
        if not np.allclose(cv, expect, rtol=0.0, atol=1e-9 * scale):
            return None

        lev = np.asarray(mesh.level)
        origin = lo.min(axis=0)
        groups: dict = {}
        for l in np.unique(lev):
            sel = np.where(lev == l)[0]
            h = np.median(size[sel], axis=0)
            if not np.allclose(size[sel], h[None], rtol=1e-9, atol=0.0):
                return None
            f = (lo[sel] - origin[None]) / h[None]
            ij = np.round(f).astype(np.int64)
            if np.abs(f - ij).max() > 1e-6:
                return None
            ij -= ij.min(axis=0)
            ext = ij.max(axis=0) + 1
            occ = np.full(tuple(ext), -1, dtype=np.int64)
            if (occ[tuple(ij.T)] >= 0).any():      # duplicate lattice slot
                return None
            occ[tuple(ij.T)] = sel
            bricks = PatchGrid._cover_boxes(occ, dim)
            if bricks is None:
                return None
            for b in bricks:
                groups.setdefault(b.shape, []).append(b)
        if sum(len(v) for v in groups.values()) > max_bricks:
            return None
        out = [np.stack(v) for v in groups.values()]
        for g in out:
            if not PatchGrid._verify(cells, g, dim):
                return None
        return PatchGrid(dim, out)

    @staticmethod
    def _cover_boxes(occ, dim):
        """Greedy maximal-box cover of the occupied lattice slots."""
        taken = occ < 0
        boxes = []
        while True:
            rem = np.argwhere(~taken)
            if rem.size == 0:
                break
            if len(boxes) > 256:
                return None
            p0 = rem[0]
            ext = []
            for a in range(dim):
                n = 1
                while True:
                    q = list(p0)
                    q[a] = p0[a] + n
                    if q[a] >= occ.shape[a]:
                        break
                    # the full slab [p0 : p0+ext, q_a] must be free
                    sl = tuple(slice(p0[t], p0[t] + ext[t]) if t < a
                               else (q[a] if t == a else p0[t])
                               for t in range(dim))
                    blk = taken[sl]
                    if np.any(blk):
                        break
                    n += 1
                ext.append(n)
            sl = tuple(slice(p0[t], p0[t] + ext[t]) for t in range(dim))
            boxes.append(occ[sl].copy())
            taken[sl] = True
        return boxes

    # -- z-order patches (uniform refine_global, curved grids OK) -------
    @staticmethod
    def _build_zorder(mesh) -> Optional["PatchGrid"]:
        dim = mesh.dim
        lev = np.asarray(mesh.level)
        r = int(lev[0])
        if r < 0 or np.any(lev != r):
            return None
        m = 1 << r
        md = m ** dim
        if mesh.n_cells % md:
            return None
        n_p = mesh.n_cells // md
        # z-order decode: q's base-2^dim digits, most-significant = first
        # refinement round; each digit's bit t -> axis t
        q = np.arange(md)
        ax = [np.zeros(md, dtype=np.int64) for _ in range(dim)]
        for t in range(r):
            z = (q >> (dim * (r - 1 - t))) & (2 ** dim - 1)
            for a in range(dim):
                ax[a] = (ax[a] << 1) | ((z >> a) & 1)
        cell_of = np.zeros((n_p,) + (m,) * dim, dtype=np.int64)
        cell_of[(slice(None),) + tuple(ax)] = \
            np.arange(n_p)[:, None] * md + q[None, :]
        cells = np.asarray(mesh.cells)
        if not PatchGrid._verify(cells, cell_of, dim):
            return None
        if dim == 2:
            merged = PatchGrid._try_merge_2d(cells, cell_of, m)
            if merged is not None:
                return merged
        return PatchGrid(dim, [cell_of])

    @staticmethod
    def _try_merge_2d(cells, cell_of, m) -> Optional["PatchGrid"]:
        """Arrange 2D patches into one rectangular super-patch if their
        adjacency forms a perfect grid with consistent orientation."""
        n_p = cell_of.shape[0]
        if n_p == 1:
            return PatchGrid(2, [cell_of])
        # +x neighbor: q whose left-edge first cell shares p's right-edge
        # first cell's (v1, v3) as its (v0, v2); +y via (v2, v3)/(v0, v1)
        left_key = {}
        bot_key = {}
        for p in range(n_p):
            c = cells[cell_of[p, 0, 0]]
            left_key[(c[0], c[2])] = p
            bot_key[(c[0], c[1])] = p
        px = np.full(n_p, -1, np.int64)
        py = np.full(n_p, -1, np.int64)
        for p in range(n_p):
            c = cells[cell_of[p, -1, 0]]
            px[p] = left_key.get((c[1], c[3]), -1)
            c = cells[cell_of[p, 0, -1]]
            py[p] = bot_key.get((c[2], c[3]), -1)
        starts = [p for p in range(n_p)
                  if p not in set(px[px >= 0]) and p not in set(py[py >= 0])]
        if len(starts) != 1:
            return None
        rows = []
        row_start = starts[0]
        seen = set()
        while row_start != -1:
            row = []
            p = row_start
            while p != -1:
                if p in seen:
                    return None
                seen.add(p)
                row.append(p)
                p = px[p]
            rows.append(row)
            row_start = py[row_start]
        if len(seen) != n_p or any(len(r) != len(rows[0]) for r in rows):
            return None
        nx, ny = len(rows[0]), len(rows)
        pos = np.array(rows, dtype=np.int64)        # (ny, nx)
        mc = np.zeros((1, nx * m, ny * m), dtype=np.int64)
        for iy in range(ny):
            for ix in range(nx):
                mc[0, ix * m:(ix + 1) * m, iy * m:(iy + 1) * m] = \
                    cell_of[pos[iy, ix]]
        if not PatchGrid._verify(cells, mc, 2):
            return None
        return PatchGrid(2, [mc])


class _Group:
    """Static per-shape-group tables (host-built)."""

    def __init__(self, cell_of, k, base):
        self.cell_of = cell_of
        shape = cell_of.shape[1:]
        self.n_b = int(cell_of.shape[0])
        self.m = tuple(int(x) for x in shape)
        self.G = tuple(k * x + 1 for x in self.m)
        self.Gp = tuple(x + 2 * k for x in self.G)
        M = 1
        for x in self.Gp:
            M *= x
        self.M = M
        self.base = base                   # slot offset in Np_total
        # strides of the flattened bordered grid (x-major, last fastest)
        dim = len(self.m)
        st = [1] * dim
        for a in range(dim - 2, -1, -1):
            st[a] = st[a + 1] * self.Gp[a + 1]
        self.strides = tuple(st)
        S = 2 * k + 1
        self.offsets = tuple(
            sum(s[a] * st[a] for a in range(dim))
            for s in product(range(S), repeat=dim))
        self.F = k * sum(st)


class StencilOperator:
    """Q_k stencil operator on a PatchGrid for d-vector nodal fields.

    Host-built static tables; `build_weights` turns per-Newton element
    node-blocks into per-group stencil tensors; `matvec` applies them.
    Patch vectors are flat (d * Np_total) in the d-first bordered layout
    (module docstring).  `spread`/`unspread` convert to/from flat global
    node vectors; `weight` is the ownership mask for weighted inner
    products; `spread_blockdiag` lifts a nodal (d x d) block-Jacobi into
    the layout; `flat_matvec` is the flat->flat wrapper for
    Constraints.wrap_operator on hanging-node meshes.
    """

    def __init__(self, grid: PatchGrid, space, d: int = 1, device=None):
        k = space.degree
        dim = grid.dim
        nl = (k + 1) ** dim
        cd = np.asarray(space.cell_dofs)
        if cd.shape[1] != nl:
            raise ValueError("space/degree mismatch")
        n_nodes = space.n_nodes
        dev = _device(device)
        self.device = dev

        self.space = space
        self.grid = grid
        self.k, self.d, self.dim = k, d, dim
        self.n_nodes = n_nodes
        self.S = 2 * k + 1

        groups = []
        base = 0
        flat_nodes_parts = []
        slot_parts = []
        for cell_of in grid.groups:
            g = _Group(cell_of, k, base)
            groups.append(g)
            node_grid = np.full((g.n_b,) + g.G, -1, dtype=np.int64)
            cdc = cd[cell_of]                       # (n_b, *m, nl)
            sels = []
            for a in product(range(k + 1), repeat=dim):
                l = _lex(a, k)
                sel = (slice(None),) + np.ix_(*[
                    np.arange(g.m[t]) * k + a[t] for t in range(dim)])
                node_grid[sel] = cdc[..., l]
                sels.append((sel, l))
            # consistency: overlapping writes (shared entity nodes) must
            # all agree — neighbor cells number shared nodes identically
            for sel, l in sels:
                if not np.array_equal(node_grid[sel], cdc[..., l]):
                    raise AssertionError("inconsistent brick node grid")
            assert (node_grid >= 0).all()
            # interior slot (bordered, flattened) of node (b, i1..iD)
            pm = np.zeros(g.G, dtype=np.int64)
            for t in range(dim):
                sh = [1] * dim
                sh[t] = g.G[t]
                pm = pm + ((np.arange(g.G[t]) + k) *
                           g.strides[t]).reshape(sh)
            slot = (base + np.arange(g.n_b)[:, None] * g.M +
                    pm.reshape(-1)[None])           # (n_b, prod G)
            flat_nodes_parts.append(node_grid.reshape(-1))
            slot_parts.append(slot.reshape(-1))
            base += g.n_b * g.M
        self._groups = groups
        Np_total = base
        self.Np_total = Np_total
        self.n_slots = d * Np_total
        flat_nodes = np.concatenate(flat_nodes_parts)
        slot_of = np.concatenate(slot_parts)

        # pad_node: node id per slot, sentinel n_nodes at borders
        pad_node = np.full(Np_total, n_nodes, dtype=np.int64)
        pad_node[slot_of] = flat_nodes

        # ownership: first occurrence of each node (among interior slots)
        uniq, first_idx = np.unique(flat_nodes, return_index=True)
        assert uniq.size == n_nodes, "bricks do not cover all nodes"
        first_slot = np.zeros(n_nodes, dtype=np.int64)
        first_slot[uniq] = slot_of[first_idx]
        own = np.zeros(Np_total, dtype=bool)
        own[slot_of[first_idx]] = True

        # gather-only combine tables: fixed-width duplicate list + a
        # seg-of-slot select map
        counts = np.bincount(flat_nodes, minlength=n_nodes)
        dup_nodes = np.where(counts > 1)[0]
        n_sh = dup_nodes.size
        maxc = int(counts.max()) if n_sh else 1
        node_to_seg = np.full(n_nodes, -1, np.int64)
        node_to_seg[dup_nodes] = np.arange(n_sh)
        # tab padded with slot 0 — always a border slot (k >= 1), which a
        # matvec leaves exactly zero (W has no entries on border rows)
        tab = np.zeros((max(n_sh, 1), maxc), np.int64)
        fill = np.zeros(max(n_sh, 1), np.int64)
        segs = node_to_seg[flat_nodes]
        md = segs >= 0
        for s_i, sg in zip(slot_of[md], segs[md]):
            tab[sg, fill[sg]] = s_i
            fill[sg] += 1
        seg_of = np.zeros(Np_total, np.int64)
        is_dup = np.zeros(Np_total, bool)
        seg_of[slot_of[md]] = segs[md]
        is_dup[slot_of[md]] = True

        def i64(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        self._own = own
        self.pad_node = i64(pad_node)
        self.first_slot = i64(first_slot)
        self.comb_tab = i64(tab)
        self.comb_seg = i64(seg_of)
        self.comb_dup = torch.as_tensor(is_dup, device=dev)
        self.n_shared = n_sh
        self._perm = [i64(g.cell_of.reshape(-1)) for g in groups]

    # -- layout maps ----------------------------------------------------
    # Component counts are inferred from vector/tensor sizes, so one
    # operator instance serves rectangular sub-blocks too.

    def weight(self, dtype=torch.float32, d=None):
        """Ownership weights (1 owned / 0 duplicate or pad), flat
        (d*Np_total,)."""
        d = self.d if d is None else d
        w = torch.as_tensor(self._own, dtype=dtype, device=self.device)
        return w[None].expand(d, w.shape[0]).reshape(-1)

    def spread(self, x):
        """Global flat (n_nodes*d,) -> patch flat (d*Np_total,)."""
        d = x.numel() // self.n_nodes
        v = x.reshape(self.n_nodes, d).T               # (d, n_nodes)
        v = torch.cat([v, torch.zeros((d, 1), dtype=v.dtype,
                                      device=v.device)], dim=1)
        return v[:, self.pad_node].reshape(-1)

    def spread_mask(self, mask):
        """Boolean/float per-dof mask -> flat patch layout; pad slots get
        0/False."""
        return self.spread(mask)

    def unspread(self, X):
        """Patch flat -> global flat, reading the owning copy."""
        v = X.reshape(-1, self.Np_total)[:, self.first_slot]
        return v.T.reshape(-1)

    def spread_blockdiag(self, D):
        """Nodal (n_nodes, d, d) block-Jacobi -> apply closure on flat
        patch vectors (pad slots pass through zero inputs unchanged)."""
        d = self.d
        Dp = torch.cat([D, torch.eye(d, dtype=D.dtype,
                                     device=D.device)[None]], dim=0)
        # (the JAX package's transpose(2, 3, 0, 1) of this 3-D array
        # raises: its block-Jacobi stencil branch cannot run)
        Dt = Dp[self.pad_node].permute(1, 2, 0)       # (d, d, Np)

        def apply(r):
            return torch.einsum("abn,bn->an", Dt, r.reshape(d, -1)
                                ).reshape(-1)
        return apply

    # -- per-Newton weight build ----------------------------------------
    def build_weights(self, Ab):
        """Element node-blocks (n_c, nl, d_out, nl, d_in) -> per-group
        stencil tensors [(S^dim, d_out, d_in, n_b, M)], own-brick
        contributions only, zero on the k-wide border rows.

        Accumulation happens in PHASE-MAJOR coordinates (node i = k*ci + a
        stored at [a % k, ci + a // k]), where each of the (k+1)^(2 dim)
        slice-adds is a contiguous slab; one transpose/reshape interleaves
        the phases back to the bordered grid layout at the end."""
        k, dim, S = self.k, self.dim, self.S
        d_out, d_in = Ab.shape[2], Ab.shape[4]
        nl = (k + 1) ** dim
        Ws = []
        for g, perm in zip(self._groups, self._perm):
            Ec = Ab[perm].reshape((g.n_b,) + g.m + (nl, d_out, nl, d_in))
            ph_shape = (S ** dim, d_out, d_in, g.n_b)
            for t in range(dim):
                ph_shape += (k, g.m[t] + 1)
            Wph = torch.zeros(ph_shape, dtype=Ab.dtype, device=Ab.device)
            for a in product(range(k + 1), repeat=dim):
                l1 = _lex(a, k)
                for a2 in product(range(k + 1), repeat=dim):
                    l2 = _lex(a2, k)
                    # offsets iterate product(range(S), repeat=dim) with
                    # axis 0 slowest -> sf = sum s_t * S^(dim-1-t)
                    sf = sum((a2[t] - a[t] + k) * S ** (dim - 1 - t)
                             for t in range(dim))
                    blk = Ec[(slice(None),) * (1 + dim) + (l1, slice(None),
                                                           l2, slice(None))]
                    # (n_b, *m, d, d) -> (d, d, n_b, *m)
                    blk = torch.movedim(blk, (-2, -1, 0), (0, 1, 2))
                    # phase slot [a%k, a//k : a//k + m] per axis
                    idx = (sf, slice(None), slice(None), slice(None))
                    for t in range(dim):
                        ai, ao = a[t] % k, a[t] // k
                        idx += (ai, slice(ao, ao + g.m[t]))
                    Wph[idx] += blk
            # interleave phases -> grid rows i = k*ci' + a' (ci' major),
            # trim the phase padding to G, add the k-wide border
            axes = [0, 1, 2, 3]
            for t in range(dim):
                axes += [4 + 2 * t + 1, 4 + 2 * t]
            Wg = Wph.permute(axes).reshape(
                (S ** dim, d_out, d_in, g.n_b) +
                tuple(k * (g.m[t] + 1) for t in range(dim)))
            Wg = Wg[(Ellipsis,) + tuple(slice(0, g.G[t])
                                        for t in range(dim))]
            Wg = F.pad(Wg, (k, k) * dim)
            Ws.append(Wg.reshape(S ** dim, d_out, d_in, g.n_b, g.M))
        return tuple(Ws)

    # -- apply ------------------------------------------------------------
    def combine(self, Y):
        """Sum duplicated copies of shared nodes and write the total back
        into every copy.  Y: (n_slots,) flat patch vector.  Identity for a
        single-brick grid (no shared nodes)."""
        if self.n_shared == 0:
            return Y
        v = Y.reshape(-1, self.Np_total)
        tot = v[:, self.comb_tab].sum(dim=2)          # (d, n_shared)
        out = torch.where(self.comb_dup[None], tot[:, self.comb_seg], v)
        return out.reshape(-1)

    def slice_weights(self, Ws, rows, cols):
        """Component sub-block of a built stencil: W[:, rows, cols]
        applies the corresponding rectangular operator block."""
        return tuple(W[:, rows, cols] for W in Ws)

    def matvec(self, Ws, x):
        """y = A x in patch layout (x flat (d_in*Np_total,), y flat
        (d_out*Np_total,); d_in/d_out from the W tensors).

        The S^dim shifted windows of the guarded input are one strided
        VIEW (window s starts at sum_t s_t * stride_t), so the whole apply
        is one broadcast multiply and one sum per brick group."""
        d_out, d_in = Ws[0].shape[1], Ws[0].shape[2]
        dim, S = self.dim, self.S
        X = x.reshape(d_in, self.Np_total)
        ys = []
        for g, W in zip(self._groups, Ws):
            Xg = X[:, g.base:g.base + g.n_b * g.M].reshape(
                d_in, g.n_b, g.M)
            Xp = F.pad(Xg, (g.F, g.F))
            win = Xp.as_strided(
                (d_in, g.n_b) + (S,) * dim + (g.M,),
                (Xp.stride(0), Xp.stride(1)) + g.strides + (1,))
            win = win.permute(tuple(range(2, 2 + dim)) + (0, 1, 2 + dim))
            Wv = W.reshape((S,) * dim + (d_out, d_in, g.n_b, g.M))
            # two sums over outer axes: far faster than one multi-axis
            # reduction on the CPU, and two plain reductions on the GPU
            y = (Wv * win.unsqueeze(dim)).reshape(
                W.shape).sum(dim=0).sum(dim=1)
            ys.append(y.reshape(d_out, -1))
        Y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
        return self.combine(Y.reshape(-1))

    def flat_matvec(self, Ws, x):
        """Flat (n_nodes*d,) -> flat raw apply: spread -> stencil ->
        combine -> unspread.  Drop-in for the element matvec inside
        Constraints.wrap_operator on hanging-node meshes."""
        return self.unspread(self.matvec(Ws, self.spread(x)))

    def condensed_matvec(self, W, fixed_patch, x):
        """Constraint-condensed apply (Dirichlet-only meshes): identity on
        fixed dofs, fixed columns zeroed — matches
        Constraints.wrap_operator for any_hanging == False.
        fixed_patch: flat (n_slots,) bool (spread_mask of cons.fixed)."""
        xz = torch.where(fixed_patch, 0.0, x)
        y = self.matvec(W, xz)
        return torch.where(fixed_patch, x, y)
