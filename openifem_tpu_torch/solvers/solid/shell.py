"""Flat-shell solid solver (static membrane + Mindlin plate).

Counterpart of openifem_tpu/solvers/solid/shell.py (reference:
include/shell_solid_solver.h, source/shell_solid_solver.cpp - a wrapper
over the optional libMesh `shell-element` library, off by default).  A
native replacement with the same role: a STATIC flat-shell solve on a 2D
mesh embedded in 3D (dim=2, spacedim=3), exposing a 3-component nodal
displacement field like SolidSolver<2,3>.

For a planar mesh the flat shell decouples into
 - membrane: plane stress on the in-plane displacements (u1, u2)
 - bending: a Mindlin-Reissner plate (w, beta1, beta2), with full 2x2
   integration of bending and reduced 1x1 integration of the transverse
   shear (selective reduced integration against shear locking).
Five local dofs per node; the rotations stay internal and the public
field is the global displacement u = u1 e1 + u2 e2 + w n (the
reference's wrapper likewise keeps its rotation dofs private,
include/shell_solid_solver.h:91-99).

The stiffness apply is element_matvec on (n_cells, 20, 20) blocks for Q1
(5 dofs x 4 nodes), inside the constraint wrap, under a Jacobi CG: on a
CUDA tensor it launches the element-matvec kernel.  The element blocks,
the rhs and the Dirichlet mask are assembled on the host in float64, as
in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...config import device as _device
from ...config import index_dtype, real_dtype
from ...fe.fevalues import cell_values
from ...fe.space import FESpace
from ...la.constraints import Constraints
from ...la.krylov import cg
from ...la.operators import element_diag, element_matvec
from ...mesh.mesh import Mesh
from ...parameters import AllParameters, component_flag_to_mask


def _b_membrane(g):
    """Voigt membrane strain rows (3, 5 nl) from (u1, u2)."""
    B = np.zeros(g.shape[:2] + (3, g.shape[2] * 5))
    B[:, :, 0, 0::5] = g[..., 0]
    B[:, :, 1, 1::5] = g[..., 1]
    B[:, :, 2, 0::5] = g[..., 1]
    B[:, :, 2, 1::5] = g[..., 0]
    return B


def _b_bending(g):
    """Voigt curvature rows (3, 5 nl) from the rotations (b1, b2)."""
    B = np.zeros(g.shape[:2] + (3, g.shape[2] * 5))
    B[:, :, 0, 3::5] = g[..., 0]     # b1,1
    B[:, :, 1, 4::5] = g[..., 1]     # b2,2
    B[:, :, 2, 3::5] = g[..., 1]
    B[:, :, 2, 4::5] = g[..., 0]
    return B


def _b_shear(g, N):
    """Transverse shear strain rows (2, 5 nl): grad w - beta."""
    B = np.zeros(g.shape[:2] + (2, g.shape[2] * 5))
    B[:, :, 0, 2::5] = g[..., 0]     # w,1
    B[:, :, 0, 3::5] = -N[None, :, :]
    B[:, :, 1, 2::5] = g[..., 1]     # w,2
    B[:, :, 1, 4::5] = -N[None, :, :]
    return B


class ShellSolidSolver:
    shear_correction = 5.0 / 6.0

    def __init__(self, mesh3d, params: AllParameters, thickness: float = 0.1,
                 device=None):
        """mesh3d: a Mesh of dim-2 cells whose vertices carry 3D (or 2D)
        coordinates lying in a plane (the reference converts the deal.II
        Triangulation<2,3> the same way, source/shell_solid_solver.cpp:
        83-131).  device: torch device of the solve (default
        config.device())."""
        self.mesh3d = mesh3d
        self.params = params
        self.thickness = thickness
        self.device = _device(device)
        self.surface_load = None
        self._setup_done = False

    def set_surface_load(self, fn: Callable):
        """fn(points (n,3)) -> (n,3) force per unit area."""
        self.surface_load = fn

    # ------------------------------------------------------------------
    def _frame(self):
        """(rows e1, e2, n of the plane frame from the first cell,
        origin, vertex coordinates in that frame)."""
        V3 = np.asarray(self.mesh3d.vertices, dtype=np.float64)
        if V3.shape[1] == 2:
            V3 = np.concatenate([V3, np.zeros((len(V3), 1))], axis=1)
        c0 = self.mesh3d.cells[0]
        e1 = V3[c0[1]] - V3[c0[0]]
        e1 /= np.linalg.norm(e1)
        n = np.cross(e1, V3[c0[2]] - V3[c0[0]])
        n /= np.linalg.norm(n)
        frame = np.stack([e1, np.cross(n, e1), n])
        origin = V3[c0[0]]
        local = (V3 - origin) @ frame.T
        assert np.abs(local[:, 2]).max() < 1e-9 * (1 + np.abs(local).max()), \
            "shell mesh must be planar"
        return frame, origin, local

    def _stiffness_blocks(self):
        """(n_c, 5 nl, 5 nl) element stiffness: membrane and bending at
        full integration, shear at the one-point rule."""
        E, nu = self.params.E[0], self.params.nu[0]
        t = self.thickness
        C = (E / (1 - nu ** 2)) * np.array(
            [[1, nu, 0], [nu, 1, 0], [0, 0, (1 - nu) / 2]])
        ks = self.shear_correction * E / (2 * (1 + nu)) * t
        cvf, cvr = self.cv, self.cv1
        Bm, Bb = _b_membrane(cvf.grad), _b_bending(cvf.grad)
        K = (np.einsum("cqia,ij,cqjb,cq->cab", Bm, C * t, Bm, cvf.JxW,
                       optimize=True) +
             np.einsum("cqia,ij,cqjb,cq->cab", Bb, C * t ** 3 / 12.0, Bb,
                       cvf.JxW, optimize=True))
        Bs = _b_shear(cvr.grad, cvr.N)
        return K + ks * np.einsum("cqia,cqib,cq->cab", Bs, Bs, cvr.JxW,
                                  optimize=True)

    def _dirichlet_mask(self):
        """Translation flags map through the frame; a constrained
        translation normal to the plane also clamps the rotations (the
        flat-plate convention)."""
        dmask = np.zeros(self.n_dofs, dtype=bool)
        bmap = self.space.boundary_node_map()
        for bid, flag in self.params.solid_dirichlet_bcs.items():
            if bid not in bmap:
                continue
            gmask = np.array(component_flag_to_mask(flag, 3), dtype=float)
            lmask = (np.abs(self.frame) @ gmask) > 1e-12
            base = bmap[bid] * 5
            for k in range(3):
                if lmask[k]:
                    dmask[base + k] = True
            if lmask[2]:
                dmask[base + 3] = True
                dmask[base + 4] = True
        return dmask

    def _load_rhs(self):
        """Surface load at the quadrature points, in the local frame, on
        the translation dofs."""
        cvf = self.cv
        n_c, n_q = cvf.JxW.shape
        rhs = np.zeros(self.n_dofs)
        load = np.zeros((n_c, n_q, 3))
        if self.surface_load is not None:
            pts3 = cvf.xq.reshape(-1, 2) @ self.frame[:2] + self._origin
            load = np.asarray(self.surface_load(pts3)).reshape(n_c, n_q, 3)
        lload = np.einsum("cqg,lg->cql", load, self.frame)
        for comp in range(3):
            rl = np.einsum("qi,cq,cq->ci", cvf.N, lload[..., comp], cvf.JxW)
            np.add.at(rhs, self.space.cell_dofs.ravel() * 5 + comp,
                      rl.ravel())
        return rhs

    def setup(self):
        params = self.params
        self.frame, self._origin, local = self._frame()
        self.mesh2 = Mesh(dim=2, vertices=local[:, :2],
                          cells=self.mesh3d.cells,
                          material_id=self.mesh3d.material_id,
                          boundary_id=self.mesh3d.boundary_id)
        self.space = FESpace(self.mesh2, params.solid_degree)
        self.cv = cell_values(self.space, params.solid_degree + 1)
        self.cv1 = cell_values(self.space, 1)  # reduced (1-point) rule
        self.n_nodes = self.space.n_nodes
        ndof = self.n_dofs = 5 * self.n_nodes
        dev, rdt = self.device, real_dtype()

        self.K_loc = torch.as_tensor(self._stiffness_blocks(), dtype=rdt,
                                     device=dev)
        cd = self.space.cell_dofs
        # the kernel's persistent table (its gather plan is built once)
        self.cell_dofs = torch.as_tensor(
            (cd[:, :, None] * 5 + np.arange(5)).reshape(len(cd), -1),
            dtype=index_dtype, device=dev)
        self.constraints = Constraints(ndof,
                                       dirichlet_mask=self._dirichlet_mask(),
                                       device=dev)
        self.rhs = torch.as_tensor(self._load_rhs(), dtype=rdt, device=dev)
        cons = self.constraints
        self._op = cons.wrap_operator(lambda x: element_matvec(
            self.K_loc, self.cell_dofs, ndof, x))
        diag = torch.where(cons.fixed, 1.0,
                           element_diag(self.K_loc, self.cell_dofs, ndof))
        self._dinv = torch.where(diag != 0, 1.0 / diag, 1.0)
        self._setup_done = True

    # ------------------------------------------------------------------
    def run(self):
        """Static solve (the reference's shell solver is static, its
        run_one_step is empty: source/shell_solid_solver.cpp:81): Jacobi
        CG to 1e-10 ||b||, at most 20 n_dofs iterations; the count is
        kept in self.cg_iters."""
        if not self._setup_done:
            self.setup()
        cons = self.constraints
        b = cons.condense_rhs(self.rhs)
        res = cg(self._op, b, M=lambda r: r * self._dinv,
                 atol=1e-10 * torch.linalg.vector_norm(b).item(),
                 maxiter=20 * self.n_dofs)
        self.cg_iters = res.iters
        d = cons.distribute(res.x)
        self.local_solution = d
        dl = d.reshape(-1, 5)
        frame = torch.as_tensor(self.frame, dtype=d.dtype, device=d.device)
        # global displacement field (3 components per node)
        self.current_displacement = (dl[:, :3] @ frame).reshape(-1)
        self.rotations = dl[:, 3:5]
        return self.current_displacement

    def get_current_solution(self):
        return self.current_displacement
