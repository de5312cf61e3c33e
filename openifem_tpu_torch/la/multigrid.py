"""Geometric and Galerkin multigrid V-cycles on nested mesh hierarchies.

Counterpart of openifem_tpu/la/multigrid.py.  The reference preconditions
its pressure mass-Schur and velocity blocks with ILU / direct
factorizations (source/insim.cpp:69-127, MUMPS/UMFPACK) whose iteration
counts are mesh-independent; the Krylov inner solves that replace them
grow ~1/h under refinement.  A V-cycle restores mesh independence:

- prolongation tables from the refinement history (``family`` /
  ``child_index`` of ``Mesh.refine_global``), or located geometrically
  for other nested pairs;
- Chebyshev smoothing on the Jacobi-scaled operator (no dot products),
  every sweep a chain of element-block matvecs (la/operators.py, the CUDA
  kernel on a GPU);
- a dense coarse solve: a host pseudo-inverse for GeometricMG, a
  Newton-Schulz inverse rebuilt per call for GalerkinMG.

Host-side setup is numpy (the Chebyshev eigenvalue estimates draw from
np.random.default_rng(0), as in the JAX package, so both packages use the
same numbers); per-call work is PyTorch on the solver's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import device as _device
from ..config import index_dtype
from ..fe.fevalues import cell_values
from ..fe.shapes import QkShapes
from ..fe.space import FESpace
from ..la.operators import element_matvec, element_matvec_nodeblock


def _expand_dofs(cd, k):
    """Node table (n_c, nl) -> interleaved dof table (n_c, nl*k)."""
    if k == 1:
        return cd
    nl = cd.shape[1]
    return np.repeat(cd * k, k, axis=1) + np.tile(np.arange(k), nl)


# ----------------------------------------------------------------------
# prolongation tables
# ----------------------------------------------------------------------

def prolongation_table(coarse_space: FESpace, fine_space: FESpace):
    """Interpolation table from coarse nodes to fine nodes.

    Requires fine_space.mesh = coarse_space.mesh.refine_global(1) (children
    carry family = parent cell id and child_index = z-order quadrant).

    Returns (cells (n_fine,), weights (n_fine, nl_coarse)): fine node value
    = sum_l weights[f, l] * x_coarse[coarse_cell_dofs[cells[f], l]].  Exact
    for nested Q1/Q2 spaces (unit-space embedding)."""
    fm, cm = fine_space.mesh, coarse_space.mesh
    dim = fm.dim
    assert np.all(fm.family >= 0) and np.all(fm.child_index >= 0), \
        "fine mesh must be a full refinement recording parents"
    # a PARTIAL refine() of a mesh whose cells all carry family records
    # would pass the check above but map unrefined cells to wrong parents:
    # require the exact cell count and 2**dim children per parent
    assert fm.n_cells == cm.n_cells * 2 ** dim, \
        "fine mesh is not a full refinement of the coarse mesh"
    counts = np.bincount((fm.family - fm.family.min()).astype(np.int64),
                         minlength=cm.n_cells)
    assert len(counts) == cm.n_cells and np.all(counts == 2 ** dim), \
        "fine mesh families do not cover every coarse cell 2**dim times"
    n_fine = fine_space.n_nodes
    nl = fine_space.cell_dofs.shape[1]
    local = fine_space.shapes.local_nodes()          # (nl, dim) unit coords

    # first (cell, local) occurrence of each fine node
    cell_of = np.zeros(n_fine, dtype=np.int64)
    loc_of = np.zeros(n_fine, dtype=np.int64)
    flat = fine_space.cell_dofs.reshape(-1)
    order = np.arange(len(flat) - 1, -1, -1)         # reversed: first wins
    cell_of[flat[order]] = order // nl
    loc_of[flat[order]] = order % nl

    # z-order child offset within the parent unit cell
    ci = fm.child_index[cell_of].astype(np.int64)    # (n_fine,)
    offs = np.stack([(ci >> d) & 1 for d in range(dim)], axis=-1)
    unit_parent = (offs + local[loc_of]) * 0.5       # (n_fine, dim)

    # family id = fam_base + parent index for a full refine, so
    # subtracting the minimum recovers the parent index
    parent = (fm.family[cell_of] - fm.family.min()).astype(np.int64)
    assert parent.max() < cm.n_cells
    W, _ = coarse_space.shapes.evaluate(unit_parent)
    return parent, W


def _cpu_locate(mesh, points, tol):
    """Containing cell and unit coordinates of host points in `mesh`
    (setup-time host work: the cell hash on the CPU in float64)."""
    from ..fsi.interp import make_cell_hash, plan_cell_hash
    verts = mesh.vertices[mesh.cells]
    dims, span, K = plan_cell_hash(verts, tol=tol)
    build, locate = make_cell_hash(mesh.n_cells, dims, span, K, tol=tol,
                                   device="cpu")
    f64 = dict(dtype=torch.float64, device="cpu")
    idx, unit, found = locate(build(torch.as_tensor(verts, **f64)),
                              torch.as_tensor(points, **f64))
    return idx.numpy(), unit.numpy(), found.numpy()


def geometric_prolongation_table(coarse_space: FESpace,
                                 fine_space: FESpace, tol: float = 1e-9):
    """(cells, W) like prolongation_table, but located geometrically via
    the uniform-grid cell hash — valid for ANY coarse/fine mesh pair whose
    fine nodes lie inside the coarse mesh (locally refined meshes)."""
    idx, unit, found = _cpu_locate(coarse_space.mesh,
                                   fine_space.node_points, tol)
    assert found.all(), \
        "fine node outside the coarse mesh (non-nested hierarchy)"
    W, _ = coarse_space.shapes.evaluate(unit)
    return idx.astype(np.int64), W


def node_injection_table(coarse_space: FESpace, fine_space: FESpace):
    """For each coarse node, the fine node at the same support point
    (nested refine_global levels of the same Q_k space).  Used to restrict
    fixed-dof masks exactly."""
    cm, fm = coarse_space.mesh, fine_space.mesh
    dim = cm.dim
    nchild = 2 ** dim
    parent = (fm.family - fm.family.min()).astype(np.int64)
    child_cell = np.full((cm.n_cells, nchild), -1, dtype=np.int64)
    child_cell[parent, fm.child_index.astype(np.int64)] = \
        np.arange(fm.n_cells)
    assert (child_cell >= 0).all()

    local = coarse_space.shapes.local_nodes()        # (nl, dim)
    flocal = fine_space.shapes.local_nodes()
    inj = np.full(coarse_space.n_nodes, -1, dtype=np.int64)
    for l, u in enumerate(local):
        offs = (u > 0.5).astype(np.int64)            # child quadrant bits
        k = int(sum(offs[d] << d for d in range(dim)))
        uc = 2.0 * u - offs                          # unit coords in child
        fl = int(np.argmin(np.abs(flocal - uc).sum(axis=1)))
        assert np.abs(flocal[fl] - uc).max() < 1e-12
        inj[coarse_space.cell_dofs[:, l]] = \
            fine_space.cell_dofs[child_cell[:, k], fl]
    assert (inj >= 0).all()
    return inj


def _prolong(cd, W, xc, k):
    """Fine nodal vector from coarse: sum_l W[f, l] xc[cd[f, l]]."""
    if k == 1:
        return torch.einsum("fl,fl->f", W, xc[cd])
    return torch.einsum("fl,flk->fk", W, xc.reshape(-1, k)[cd]).reshape(-1)


def _restrict(cd, W, rf, k, n_coarse_nodes):
    """Transpose of _prolong."""
    if k == 1:
        return torch.zeros(n_coarse_nodes, dtype=rf.dtype,
                           device=rf.device).index_add_(
            0, cd.reshape(-1), (W * rf[:, None]).reshape(-1))
    contrib = W[:, :, None] * rf.reshape(-1, k)[:, None, :]  # (n_f, nlc, k)
    out = torch.zeros((n_coarse_nodes, k), dtype=rf.dtype, device=rf.device)
    out.index_add_(0, cd.reshape(-1), contrib.reshape(-1, k))
    return out.reshape(-1)


def _chebyshev(mv, dinv, lmax, b, x, degree: int, x_is_zero: bool = False):
    """degree Chebyshev iterations on D^-1 A targeting [lmax/4, lmax] (the
    smoothing range); no dot products.  x_is_zero skips the initial
    residual matvec (pre-smoothing)."""
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b if x_is_zero else b - mv(x)
    z = dinv * r
    d = z / theta
    for j in range(degree):
        x = x + d
        if j == degree - 1:
            break   # the final residual/direction would be dead work
        r = b - mv(x)
        z = dinv * r
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    return x


# ----------------------------------------------------------------------
# levels
# ----------------------------------------------------------------------

class MGLevel:
    """One level: element operator blocks + smoother data."""

    def __init__(self, space: FESpace, A_loc: np.ndarray,
                 fixed: np.ndarray, dtype, cell_dofs=None, ncomp: int = 1,
                 device=None):
        dev = _device(device)
        self.space = space
        cd_np = np.asarray(cell_dofs if cell_dofs is not None
                           else space.cell_dofs)
        self.n = len(np.asarray(fixed))
        self.ncomp = ncomp
        # the element-matvec kernel takes contiguous int32 tables and
        # contiguous blocks
        self.cell_dofs = torch.as_tensor(cd_np, dtype=index_dtype,
                                         device=dev).contiguous()
        self.A_loc = torch.as_tensor(np.ascontiguousarray(A_loc),
                                     dtype=dtype, device=dev)
        if ncomp > 1:   # node-block layout: a view of A_loc (interleaved
            # dofs, node-major)
            nl = cd_np.shape[1] // ncomp
            self.cell_nodes = torch.as_tensor(
                space.cell_dofs, dtype=index_dtype, device=dev).contiguous()
            self.A_block = self.A_loc.reshape(-1, nl, ncomp, nl, ncomp)
        fixed = np.asarray(fixed, dtype=bool)
        self.fixed = torch.as_tensor(fixed, device=dev)
        # host copies for setup-time work (power iteration, coarse
        # assembly)
        self._A_np = np.asarray(A_loc, dtype=np.float64)
        self._fixed_np = fixed
        self._cd_np = cd_np

        # Jacobi diagonal
        diag = np.zeros(self.n)
        nl = cd_np.shape[1]
        dloc = self._A_np[:, np.arange(nl), np.arange(nl)]
        np.add.at(diag, cd_np.reshape(-1), dloc.reshape(-1))
        diag[fixed] = 1.0
        diag[diag == 0] = 1.0
        self.dinv = torch.as_tensor(1.0 / diag, dtype=dtype, device=dev)

        # lambda_max(D^-1 A) by power iteration (host, setup-time)
        x = np.random.default_rng(0).standard_normal(self.n)
        x[fixed] = 0.0
        lam = 1.0
        for _ in range(15):
            nrm = np.linalg.norm(x)
            if nrm == 0.0:       # degenerate (all dofs fixed) level
                lam = 1.0
                break
            x = x / nrm
            y = self._host_matvec(x)
            y = y / diag
            y[fixed] = 0.0
            lam = float(x @ y)
            x = y
        self.lam_max = 1.1 * max(lam, 1e-12)

    def _host_matvec(self, x):
        cd = self._cd_np
        xl = x[cd]                                   # (n_c, nl)
        yl = np.einsum("clm,cm->cl", self._A_np, xl)
        y = np.zeros(self.n)
        np.add.at(y, cd.reshape(-1), yl.reshape(-1))
        y[self._fixed_np] = x[self._fixed_np]
        return y

    def matvec(self, x):
        if self.ncomp > 1:
            y = element_matvec_nodeblock(self.A_block, self.cell_nodes,
                                         self.n // self.ncomp, x)
        else:
            y = element_matvec(self.A_loc, self.cell_dofs, self.n, x)
        return torch.where(self.fixed, x, y)

    def chebyshev(self, b, x, degree: int, x_is_zero: bool = False):
        return _chebyshev(self.matvec, self.dinv, self.lam_max, b, x,
                          degree, x_is_zero)


class GeometricMG:
    """V-cycle over a nested hierarchy (levels[0] coarsest).  vcycle(b)
    approximates A^-1 b for the finest-level operator and is symmetric
    (equal pre/post Chebyshev smoothing), so it is a valid CG
    preconditioner."""

    def __init__(self, levels: List[MGLevel], n_smooth: int = 2,
                 dtype=torch.float32, ncomp: int = 1, device=None):
        dev = _device(device)
        self.levels = levels
        self.n_smooth = n_smooth
        self.ncomp = ncomp
        L = len(levels)
        self.P = []           # (coarse node table (n_f, nlc), weights)
        for i in range(L - 1):
            try:
                cells, W = prolongation_table(levels[i].space,
                                              levels[i + 1].space)
            except AssertionError:
                # non-full refinement (local/hanging-node meshes): locate
                # fine nodes in the coarse mesh geometrically
                cells, W = geometric_prolongation_table(
                    levels[i].space, levels[i + 1].space)
            cd = np.asarray(levels[i].space.cell_dofs)[cells]  # (n_f, nlc)
            self.P.append((torch.as_tensor(cd, dtype=torch.int64,
                                           device=dev),
                           torch.as_tensor(W, dtype=dtype, device=dev)))

        # dense coarse inverse (host, f64), with identity fixed rows
        lv0 = levels[0]
        n0 = lv0.n
        A0 = np.zeros((n0, n0))
        cdofs = lv0._cd_np
        Al = lv0._A_np
        for c in range(len(cdofs)):
            A0[np.ix_(cdofs[c], cdofs[c])] += Al[c]
        f0 = lv0._fixed_np
        A0[f0, :] = 0.0
        A0[:, f0] = 0.0
        A0[f0, f0] = 1.0
        # pseudo-inverse: the pure-Neumann pressure Laplacian is singular
        # (constant null space); pinv gives the minimum-norm coarse
        # correction
        self.A0_inv = torch.as_tensor(np.linalg.pinv(A0, rcond=1e-10),
                                      dtype=dtype, device=dev)

    def vcycle(self, b):
        L = len(self.levels)
        b = b.to(self.levels[-1].A_loc.dtype)
        k = self.ncomp

        def cycle(i, bi):
            lv = self.levels[i]
            if i == 0:
                return self.A0_inv @ bi
            x = lv.chebyshev(bi, torch.zeros_like(bi), self.n_smooth,
                             x_is_zero=True)
            r = torch.where(lv.fixed, 0.0, bi - lv.matvec(x))
            cd, W = self.P[i - 1]
            bc = _restrict(cd, W, r, k, self.levels[i - 1].n // k)
            bc = torch.where(self.levels[i - 1].fixed, 0.0, bc)
            xc = cycle(i - 1, bc)
            x = x + _prolong(cd, W, xc, k)
            return lv.chebyshev(bi, x, self.n_smooth)

        return cycle(L - 1, b)


# ----------------------------------------------------------------------
# level and cycle constructors
# ----------------------------------------------------------------------

def laplacian_levels(meshes: Sequence, degree: int,
                     fixed_fine: Optional[np.ndarray] = None,
                     dtype=torch.float32,
                     n_q1d: Optional[int] = None,
                     fixed_prefix: bool = True,
                     device=None) -> List[MGLevel]:
    """MGLevel list for the scalar Q_degree Laplacian on nested meshes.

    fixed_fine: fine-level fixed-dof mask.  With fixed_prefix=True the
    coarser masks are its node-id prefix (refine_global appends nodes, so
    coarse node i is fine node i — exact for Q1).  fixed_prefix=False
    masks only the finest level (hierarchies not built by refine_global);
    a preconditioner-quality choice only."""
    spaces = [FESpace(m, degree) for m in meshes]
    if degree != 1 and fixed_fine is not None and np.any(fixed_fine):
        raise NotImplementedError(
            "prefix fixed-mask restriction is only valid for Q1")
    levels = []
    for s in spaces:
        cv = cell_values(s, n_q1d or degree + 1)
        K = np.einsum("cqlx,cqmx,cq->clm", cv.grad, cv.grad, cv.JxW)
        if fixed_fine is not None and (fixed_prefix
                                       or s is spaces[-1]):
            fx = np.asarray(fixed_fine)[:s.n_nodes]
        else:
            fx = np.zeros(s.n_nodes, dtype=bool)
        # zero fixed columns so the operator stays symmetric with identity
        # fixed rows (matvec handles the rows)
        colfix = fx[s.cell_dofs]                     # (n_c, nl)
        K = np.where(colfix[:, None, :] | colfix[:, :, None], 0.0, K)
        levels.append(MGLevel(s, K, fx, dtype, device=device))
    return levels


def make_pressure_mg(meshes: Sequence, fixed_fine=None, n_smooth: int = 2,
                     dtype=torch.float32, fixed_prefix: bool = True,
                     device=None) -> GeometricMG:
    """V-cycle for the pressure Schur complement B diag(Mu)^-1 B^T, which
    is spectrally a pressure Laplacian (the constant scaling is absorbed
    by the per-level Chebyshev eigenvalue estimates)."""
    return GeometricMG(laplacian_levels(meshes, 1, fixed_fine, dtype,
                                        fixed_prefix=fixed_prefix,
                                        device=device),
                       n_smooth=n_smooth, dtype=dtype, device=device)


def velocity_levels(meshes: Sequence, degree: int, d: int,
                    rho: float, mu: float, gamma: float, dt: float,
                    fixed_fine: Optional[np.ndarray] = None,
                    dtype=torch.float32, device=None) -> List[MGLevel]:
    """MGLevel list for the velocity block of the Grad-Div Newton matrix,
    A ~ (rho/dt) M + mu K + (gamma rho) G (convection left out: the cycle
    preconditions a flexible Krylov solve).  fixed_fine: (n_nodes*d,)
    interleaved fixed mask on the finest level; coarser masks are
    restricted by node injection."""
    spaces = [FESpace(m, degree) for m in meshes]
    masks = [None] * len(spaces)
    if fixed_fine is not None:
        masks[-1] = np.asarray(fixed_fine).reshape(-1, d)
        for i in range(len(spaces) - 2, -1, -1):
            inj = node_injection_table(spaces[i], spaces[i + 1])
            masks[i] = masks[i + 1][inj]
    levels = []
    for i, s in enumerate(spaces):
        cv = cell_values(s, degree + 1)
        nl = cv.N.shape[1]
        NN = np.einsum("qi,qj,cq->cij", cv.N, cv.N, cv.JxW)
        KK = np.einsum("cqix,cqjx,cq->cij", cv.grad, cv.grad, cv.JxW)
        I_d = np.eye(d)
        A = np.einsum("cij,ab->ciajb", (rho / dt) * NN + mu * KK, I_d)
        A = A + (gamma * rho) * np.einsum("cqia,cqjb,cq->ciajb",
                                          cv.grad, cv.grad, cv.JxW)
        A = A.reshape(-1, nl * d, nl * d)
        cd = _expand_dofs(s.cell_dofs, d)            # interleaved
        if masks[i] is not None:
            fx = masks[i].reshape(-1)
        else:
            fx = np.zeros(s.n_nodes * d, dtype=bool)
        colfix = fx[cd]
        A = np.where(colfix[:, None, :] | colfix[:, :, None], 0.0, A)
        levels.append(MGLevel(s, A, fx, dtype, cell_dofs=cd, ncomp=d,
                              device=device))
    return levels


def make_velocity_mg(meshes: Sequence, degree: int, d: int,
                     rho: float, mu: float, gamma: float, dt: float,
                     fixed_fine=None, n_smooth: int = 2,
                     dtype=torch.float32, device=None) -> GeometricMG:
    return GeometricMG(
        velocity_levels(meshes, degree, d, rho, mu, gamma, dt,
                        fixed_fine, dtype, device=device),
        n_smooth=n_smooth, dtype=dtype, ncomp=d, device=device)


# ----------------------------------------------------------------------
# Galerkin multigrid: coarse operators from the ACTUAL fine element
# blocks (A_c = W^T A_f W), rebuilt each Newton iteration (the reference
# re-factorizes its explicitly assembled Schur surrogates every Newton
# step: source/mpi_supg_solver.cpp:56-133, source/mpi_insim.cpp:36-50).
# ----------------------------------------------------------------------

def galerkin_table(coarse_space: FESpace, fine_space: FESpace,
                   tol: float = 1e-9):
    """Per-FINE-CELL parent coarse cell + interpolation weights.

    Returns (parent (n_fc,) int, W (n_fc, nl_f, nl_c) float64) with
    W[f, l, m] = N^coarse_m(xi of fine node l in parent cell).  Valid for
    any nested pair (full, local/hanging refinements, or coarser base
    grids of the same domain)."""
    from ..fsi.interp import invert_bilinear_cw
    cm, fm = coarse_space.mesh, fine_space.mesh
    parent, _, found = _cpu_locate(cm, fm.cell_centers(), tol)
    assert found.all(), "fine cell center outside the coarse mesh"
    parent = parent.astype(np.int64)

    # unit coords of every fine-cell node inside the parent cell
    Ng, _ = QkShapes(1, fm.dim).evaluate(fine_space.shapes.local_nodes())
    node_xyz = np.einsum("lv,cvd->cld", Ng, fm.vertices[fm.cells])
    n_fc, nl_f, d = node_xyz.shape
    pverts = cm.vertices[cm.cells][parent]           # (n_fc, 2**d, d)
    f64 = dict(dtype=torch.float64)
    px = [torch.as_tensor(node_xyz[..., a].reshape(-1), **f64)
          for a in range(d)]
    vx = [[torch.as_tensor(np.repeat(pverts[:, v, a], nl_f), **f64)
           for a in range(d)] for v in range(2 ** d)]
    xi = torch.stack(invert_bilinear_cw(px, vx), dim=-1).numpy()
    xi = np.clip(xi, 0.0, 1.0)
    W, _ = coarse_space.shapes.evaluate(xi)
    return parent, W.reshape(n_fc, nl_f, -1)


class GalerkinMG:
    """V-cycle whose level operators are Galerkin products of the fine
    element blocks, built per call.

    spaces: [coarsest ... finest] scalar FESpaces of the SAME degree as
    the fine blocks' dof map; ncomp > 1 treats blocks as node-block
    vector operators (n_c, nl, d, nl, d).

    Usage:
        mg = GalerkinMG(spaces, fine_cell_dofs, rep_blocks, fixed_fine)
        vcycle = mg.build(A_loc)     # per Newton iteration
    With rep_blocks the Chebyshev eigenvalue estimates are frozen at
    setup; without, a fixed-trip power iteration per build() tracks the
    Newton matrix."""

    dense_coarse_max = 3000   # dofs; above this the coarse solve falls
    # back to Chebyshev sweeps

    def __init__(self, spaces, fine_cell_dofs, rep_blocks, fixed_fine,
                 n_smooth: int = 2, dtype=torch.float32, ncomp: int = 1,
                 lam_safety: float = 1.15, device=None):
        dev = _device(device)
        self.n_smooth = n_smooth
        self.dtype = dtype
        self.ncomp = ncomp
        L = len(spaces)
        k = ncomp

        def i64(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        # static tables per level-pair
        self._tables_np = []  # (parent, W) host copies for setup
        self.parent = []      # (n_f_cells,) parent coarse cell
        self.Wt = []          # (n_f_cells, nl_f, nl_c)
        for i in range(L - 1):
            p, W = galerkin_table(spaces[i], spaces[i + 1])
            self._tables_np.append((p, W))
            self.parent.append(i64(p))
            self.Wt.append(torch.as_tensor(W, dtype=dtype, device=dev))

        # per-level dof maps + sizes; the level matvecs hand the kernel
        # contiguous int32 interleaved dof tables
        self._cell_dofs_np = [np.asarray(s.cell_dofs) for s in spaces]
        self.n_nodes = [s.n_nodes for s in spaces]
        fcd = np.asarray(fine_cell_dofs)
        assert fcd.shape[0] == spaces[-1].mesh.n_cells
        self._cell_dofs_np[-1] = fcd
        self.cell_dofs_k = [
            torch.as_tensor(np.ascontiguousarray(_expand_dofs(cd, k)),
                            dtype=index_dtype, device=dev)
            for cd in self._cell_dofs_np]

        fixed_fine = np.asarray(fixed_fine, dtype=bool)
        self.fixed_fine = torch.as_tensor(fixed_fine, device=dev)

        # node-interpolation prolongation per level-pair (same tables as
        # GeometricMG)
        self.P = []
        for i in range(L - 1):
            try:
                cells, W = prolongation_table(spaces[i], spaces[i + 1])
            except AssertionError:
                cells, W = geometric_prolongation_table(spaces[i],
                                                        spaces[i + 1])
            cd = np.asarray(spaces[i].cell_dofs)[cells]
            self.P.append((i64(cd), torch.as_tensor(W, dtype=dtype,
                                                    device=dev)))

        self.lam_safety = lam_safety
        if rep_blocks is None:
            self.lam = None
        else:
            self.lam = self._frozen_lams(
                np.asarray(rep_blocks, dtype=np.float64), fixed_fine)

        self.n0 = self.n_nodes[0] * k

    # -- setup helpers -------------------------------------------------
    def _frozen_lams(self, rep_blocks, fixed_fine):
        k = self.ncomp
        L = len(self.n_nodes)
        lams = []
        rng = np.random.default_rng(0)
        for i, (blocks, cd, n) in enumerate(
                self._level_blocks_host(rep_blocks)):
            diag = np.zeros(n)
            nl = cd.shape[1] * k
            cdk = _expand_dofs(cd, k)
            dloc = blocks.reshape(len(blocks), nl, nl)[
                :, np.arange(nl), np.arange(nl)]
            np.add.at(diag, cdk.reshape(-1), dloc.reshape(-1))
            diag[diag == 0] = 1.0
            if i == L - 1 and fixed_fine.any():
                diag[fixed_fine] = 1.0
            x = rng.standard_normal(n)
            lam = 1.0
            for _ in range(12):
                nrm = np.linalg.norm(x)
                if nrm == 0:
                    break
                x = x / nrm
                yl = np.einsum("clm,cm->cl",
                               blocks.reshape(len(blocks), nl, nl), x[cdk])
                y = np.zeros(n)
                np.add.at(y, cdk.reshape(-1), yl.reshape(-1))
                y = y / diag
                lam = float(x @ y)
                x = y
            lams.append(self.lam_safety * max(lam, 1e-12))
        return lams

    def _level_blocks_host(self, fine_blocks):
        """[(blocks (n_cells_i, nl*k, nl*k), cell_dofs_i, n_dofs_i)]
        coarsest first, numpy (setup only)."""
        k = self.ncomp
        out = []
        blocks = fine_blocks
        for i in range(len(self.n_nodes) - 1, 0, -1):
            out.append((blocks, self._cell_dofs_np[i], self.n_nodes[i] * k))
            parent, W = self._tables_np[i - 1]
            nl_f, nl_c = W.shape[1], W.shape[2]
            n_cc = len(self._cell_dofs_np[i - 1])
            if k == 1:
                contrib = np.einsum("fim,fij,fjn->fmn", W,
                                    blocks.reshape(-1, nl_f, nl_f), W)
            else:
                B = blocks.reshape(-1, nl_f, k, nl_f, k)
                contrib = np.einsum("fim,fiajb,fjn->fmanb", W, B, W
                                    ).reshape(-1, nl_c * k, nl_c * k)
            agg = np.zeros((n_cc, nl_c * k, nl_c * k))
            np.add.at(agg, parent, contrib)
            blocks = agg
        out.append((blocks, self._cell_dofs_np[0], self.n_nodes[0] * k))
        return out[::-1]

    @staticmethod
    def coarse_inverse(A0):
        """Newton-Schulz inverse of the (shifted) coarse matrix, in
        float32 as in the JAX package: X0 = A^T / (|A|_1 |A|_inf)
        guarantees convergence; 30 doublings cover cond <~ 1e8, plenty for
        an MG coarse CORRECTION."""
        n0 = A0.shape[0]
        A32 = A0.to(torch.float32)
        norm1 = A32.abs().sum(dim=0).max()
        norminf = A32.abs().sum(dim=1).max()
        X = A32.T / (norm1 * norminf)
        I0 = torch.eye(n0, dtype=torch.float32, device=A0.device)
        for _ in range(30):
            X = X @ (2.0 * I0 - A32 @ X)
        return X.to(A0.dtype)

    # -- per-call build --------------------------------------------------
    def build(self, fine_blocks):
        """Closure vcycle(b) over level blocks derived from fine_blocks
        (n_fine_cells, nl*k, nl*k), called per Newton iteration."""
        k = self.ncomp
        dtype = self.dtype
        fine_blocks = fine_blocks.to(dtype)
        L = len(self.n_nodes)

        level_blocks = [None] * L
        level_blocks[L - 1] = fine_blocks.contiguous()
        for i in range(L - 1, 0, -1):
            W = self.Wt[i - 1]
            nl_f, nl_c = W.shape[1], W.shape[2]
            blocks = level_blocks[i]
            if k == 1:
                contrib = torch.einsum("fim,fij,fjn->fmn", W,
                                       blocks.reshape(-1, nl_f, nl_f), W)
            else:
                B = blocks.reshape(-1, nl_f, k, nl_f, k)
                contrib = torch.einsum("fim,fiajb,fjn->fmanb", W, B, W
                                       ).reshape(-1, nl_c * k, nl_c * k)
            n_cc = len(self._cell_dofs_np[i - 1])
            level_blocks[i - 1] = torch.zeros(
                (n_cc, nl_c * k, nl_c * k), dtype=dtype,
                device=blocks.device).index_add_(0, self.parent[i - 1],
                                                 contrib)

        def level_ops(i):
            blocks = level_blocks[i]
            cdk = self.cell_dofs_k[i]
            n = self.n_nodes[i] * k
            fixed = self.fixed_fine if i == L - 1 else None

            def mv(x):
                y = element_matvec(blocks, cdk, n, x)
                return y if fixed is None else torch.where(fixed, x, y)

            dloc = torch.diagonal(blocks, dim1=1, dim2=2)
            diag = torch.zeros(n, dtype=dtype, device=blocks.device
                               ).index_add_(0, cdk.reshape(-1).long(),
                                            dloc.reshape(-1))
            if fixed is not None:
                diag = torch.where(fixed, 1.0, diag)
            diag = torch.where(diag == 0, 1.0, diag)
            return mv, 1.0 / diag, fixed

        ops = [level_ops(i) for i in range(L)]

        # dense coarse inverse with a small Tikhonov shift (the coarse op
        # may be singular for pure-Neumann problems; the shift bounds the
        # coarse correction).  A LARGE coarsest level falls back to
        # Chebyshev sweeps.
        n0 = self.n0
        if n0 <= self.dense_coarse_max:
            cd0 = self.cell_dofs_k[0].long()
            A0 = torch.zeros((n0, n0), dtype=dtype,
                             device=fine_blocks.device)
            flat = cd0[:, :, None] * n0 + cd0[:, None, :]
            A0.view(-1).index_add_(0, flat.reshape(-1),
                                   level_blocks[0].reshape(-1))
            tr = torch.trace(A0) / n0
            A0 = A0 + (1e-6 * tr) * torch.eye(n0, dtype=dtype,
                                               device=A0.device)
            A0_inv = self.coarse_inverse(A0)
        else:
            A0_inv = None

        n_smooth = self.n_smooth
        if self.lam is not None:
            lam = self.lam
        else:
            # dynamic lambda_max(D^-1 A) per level: fixed-trip power
            # iteration with a deterministic start
            lam = []
            for i in range(L):
                mv, dinv, _ = ops[i]
                n = self.n_nodes[i] * k
                x = torch.sin(torch.arange(1, n + 1, dtype=dtype,
                                           device=fine_blocks.device))
                lam_i = None
                for _ in range(8):
                    x = x / torch.clamp(torch.linalg.vector_norm(x),
                                        min=1e-30)
                    y = dinv * mv(x)
                    lam_i = torch.dot(x, y)
                    x = y
                lam.append(self.lam_safety * torch.clamp(lam_i, min=1e-12))

        def chebyshev(i, b, x, x_is_zero=False):
            mv, dinv, _ = ops[i]
            return _chebyshev(mv, dinv, lam[i], b, x, n_smooth, x_is_zero)

        def vcycle(b):
            out_dtype = b.dtype
            b = b.to(dtype)

            def cycle(i, bi):
                if i == 0:
                    if A0_inv is not None:
                        return A0_inv @ bi
                    return chebyshev(0, bi, torch.zeros_like(bi),
                                     x_is_zero=True)
                mv, dinv, fixed = ops[i]
                x = chebyshev(i, bi, torch.zeros_like(bi), x_is_zero=True)
                r = bi - mv(x)
                if fixed is not None:
                    r = torch.where(fixed, 0.0, r)
                cd, W = self.P[i - 1]
                bc = _restrict(cd, W, r, k, self.n_nodes[i - 1])
                xc = cycle(i - 1, bc)
                x = x + _prolong(cd, W, xc, k)
                return chebyshev(i, bi, x)

            return cycle(L - 1, b).to(out_dtype)

        return vcycle
