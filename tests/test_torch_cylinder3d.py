"""The Schaefer-Turek 3D-1Z channel on the port: the 3-D cylinder mesh
against the published geometry, the 2-D cylinder mesh against the JAX
package's generator bit for bit, and a Q2/Q1 InsIM on hexahedra judged by
the benchmark's plain reference (port_bench/reference/dfg_cylinder_3d.py)
at refine 0, with the reference's own float32 run as the control that has
to fail."""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "port_bench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from openifem_tpu_torch.mesh import generators  # noqa: E402
from openifem_tpu_torch.mesh.mesh import FACE_VERTICES  # noqa: E402

H = 0.41
# boundary id -> (axis, plane)
PLANES = {0: (0, -0.3), 1: (0, 2.2), 2: (1, 0.0), 3: (1, H), 4: (2, 0.0),
          5: (2, H)}
LIMITS = {"fluid_res": 1e-6, "bc_gap": 1e-11}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def channel(refine):
    """The 3-D channel refined `refine` times (built once per module)."""
    m = generators.flow_around_cylinder(3)
    return m if refine == 0 else channel(refine - 1).refine_global(1)


def _face_points(m, bid):
    cs, fs = np.nonzero(m.boundary_id == bid)
    return np.array([m.vertices[m.cells[c, FACE_VERTICES[3][f]]]
                     for c, f in zip(cs, fs)]).reshape(-1, 3)


def _vertex_jacobians(m):
    """det of the trilinear map's Jacobian at each vertex of each cell."""
    v = m.vertices[m.cells]
    out = []
    for k in range(8):
        cols = []
        for a in range(3):
            sign = 1.0 if (k >> a) & 1 == 0 else -1.0
            cols.append(sign * (v[:, k ^ (1 << a)] - v[:, k]))
        out.append(np.linalg.det(np.stack(cols, axis=-1)))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_cylinder3d_mesh_geometry(refine):
    m = channel(refine)
    assert m.n_cells == 832 * 8 ** refine
    ids = set(np.unique(m.boundary_id[m.boundary_id >= 0]).tolist())
    assert ids == set(range(7))
    for bid, (axis, plane) in PLANES.items():
        pts = _face_points(m, bid)
        assert np.abs(pts[:, axis] - plane).max() < 1e-12, bid
    cyl = _face_points(m, 6)
    r = np.hypot(cyl[:, 0] - 0.2, cyl[:, 1] - 0.2)
    assert np.abs(r - 0.05).max() < 1e-12
    # the inflow plane lies 0.5 upstream of the cylinder's axis
    assert abs(0.2 - _face_points(m, 0)[:, 0].min() - 0.5) < 1e-12
    assert _vertex_jacobians(m).min() > 0
    # no cell wider in x than the coarse bulk's spacing, 2.5 / 25 (the
    # misplaced shell fused a cell 0.607 wide); the bulk's own cells are
    # that spacing halved at each refinement
    v = m.vertices[m.cells]
    width = v[:, :, 0].max(axis=1) - v[:, :, 0].min(axis=1)
    assert width.max() < 0.1 + 1e-12
    bulk = m.material_id != 2
    assert np.abs(width[bulk] - 0.1 / 2 ** refine).max() < 1e-12
    # the shell is centred on the hole
    shell = m.material_id == 2
    centre = m.cell_centers()[shell].mean(axis=0)
    assert np.hypot(centre[0] - 0.2, centre[1] - 0.2) < 5e-3


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_cylinder3d_mesh_is_conforming(refine):
    """Every face lies in two cells or carries a boundary id, and no two
    vertices share a position: the chart points of the shell cells and the
    mean points of the bulk meet at the same vertices."""
    m = channel(refine)
    faces = np.sort(np.stack([m.cells[:, FACE_VERTICES[3][f]]
                              for f in range(6)], axis=1), axis=2)
    _, inv, cnt = np.unique(faces.reshape(-1, 4), axis=0,
                            return_inverse=True, return_counts=True)
    once = cnt[inv.ravel()] == 1
    assert cnt.max() == 2
    assert np.array_equal(once, m.boundary_id.reshape(-1) >= 0)
    keys = np.rint(m.vertices * 1e9).astype(np.int64)
    assert len(np.unique(keys, axis=0)) == m.n_vertices


def test_cylinder3d_volume_converges():
    """The cells' volume approaches the channel's less the cylinder's,
    2.5 x 0.41 x 0.41 - pi 0.05^2 0.41, from above (the cylinder's faces
    are chords of its circle, so the hole is a little small), the gap
    shrinking fourfold a refinement."""
    from openifem_tpu_torch.fe.fevalues import cell_values
    from openifem_tpu_torch.fe.space import FESpace
    exact = 2.5 * H * H - np.pi * 0.05 ** 2 * H
    gaps = [exact - cell_values(FESpace(channel(r), 1), 2).JxW.sum()
            for r in range(3)]
    assert all(g < 0 for g in gaps)
    assert gaps[1] > gaps[0] / 3.5 and gaps[2] > gaps[1] / 3.5


@pytest.mark.parametrize("name", ["cylinder", "box"])
def test_other_3d_meshes_equal_the_jax_package_bitwise(name):
    """Meshes without transfinite charts refine in 3-D as before: the
    solid cylinder (an extruded disc) and a box, refined once."""
    from openifem_tpu.mesh import generators as jax_generators

    def build(gen):
        if name == "cylinder":
            return gen.cylinder(0.5, 4.0).refine_global(1)
        return gen.subdivided_hyper_rectangle(
            [3, 2, 2], [0.0, 0.0, 0.0], [1.5, 1.0, 0.5]).refine_global(1)
    a, b = build(jax_generators), build(generators)
    for attr in ("vertices", "cells", "boundary_id", "face_manifold",
                 "material_id", "level"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), attr


@pytest.mark.parametrize("refine", [0, 1, 2, 3])
def test_cylinder2d_mesh_equals_the_jax_package_bitwise(refine):
    from openifem_tpu.mesh import generators as jax_generators
    a = jax_generators.flow_around_cylinder(2).refine_global(refine)
    b = generators.flow_around_cylinder(2).refine_global(refine)
    for name in ("vertices", "cells", "boundary_id", "face_manifold",
                 "cell_manifold", "material_id", "tfi_coarse", "tfi_rect"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


def _cell(refine=0, steps=1):
    with open(os.path.join(BENCH, "configs", "dfg_cylinder_3d.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "mixes", "r2_3d_seg3.json")) as f:
        mix = json.load(f)
    # the cell's knobs but the element A-solve: the 3-D stencil's apply is
    # slow on a CPU (test_cylinder3d_stencil_equals_the_element_operator
    # holds it to the element operator)
    mix.update(refine=refine, segment_steps=steps,
               knobs=dict(mix["knobs"], a_stencil=False))
    import traffic
    return cfg, mix, traffic.draw(mix, 2 ** 31 + 17)


def test_cylinder3d_insim_steps_pass_the_reference():
    """The host first step and one stepper step of the Q2/Q1 InsIM at
    refine 0 (832 hexahedra, 25,815 dofs), judged by the plain
    reference."""
    from configs import dfg_cylinder_3d as config
    from reference import dfg_cylinder_3d as reference
    cfg, mix, draw = _cell()
    case = config.Case(cfg, mix, draw, "cpu")
    assert case.fluid.n_dofs == 25815
    case.first_step()
    first = case.state()
    records, states = case.segment()
    assert records[0]["converged"] and records[0]["newton"] >= 1
    judged = [case.host(s) for s in [first] + states]
    assert min(np.abs(j["u"]).max() for j in judged) > 0.4
    out = reference.check(cfg, mix, draw, case.layout(), judged)
    assert out["fluid_res"] <= LIMITS["fluid_res"], out
    assert out["bc_gap"] <= LIMITS["bc_gap"], out
    assert out["fluid_res"] > 0


def test_cylinder3d_float32_control_fails():
    """The reference's own run in float32, the precision below the
    configuration's float64, fails at least one limit."""
    from reference import dfg_cylinder_3d as reference
    cfg, mix, draw = _cell()
    lay, states = reference.run(cfg, mix, draw, dtype=torch.float32)
    out = reference.check(cfg, mix, draw, lay, states)
    assert any(out[k] > v for k, v in LIMITS.items()), out


def test_cylinder3d_inflow_and_walls():
    """The constrained velocities at refine 0: the published inflow
    U = 16 Um y z (H - y)(H - z) / H^4, V = W = 0 on the plane x = -0.3,
    zero on the walls and the cylinder, nothing on the outflow."""
    from configs import dfg_cylinder_3d as config
    cfg, mix, draw = _cell()
    fluid = config.Case(cfg, mix, draw, "cpu").fluid
    x = fluid.nonzero_constraints.apply_increment(
        torch.zeros(fluid.n_dofs, dtype=torch.float64))
    u = x[:fluid.n_u].reshape(-1, 3).numpy()
    pts = fluid.u_space.node_points
    fixed = fluid.u_constraints.fixed.reshape(-1, 3).numpy()
    inlet = np.abs(pts[:, 0] + 0.3) < 1e-12
    y, z = pts[inlet, 1], pts[inlet, 2]
    um = cfg["inflow"]["umax"] * draw["inflow_scale"]
    want = 16 * um * y * z * (H - y) * (H - z) / H ** 4
    assert np.abs(u[inlet, 0] - want).max() < 1e-15
    assert np.abs(u[inlet, 1:]).max() == 0 and want.max() > 0.44
    assert fixed[inlet].all()
    assert np.abs(u[~inlet]).max() == 0
    outlet = np.abs(pts[:, 0] - 2.2) < 1e-12
    walls = ((np.abs(pts[:, 1]) < 1e-12) | (np.abs(pts[:, 1] - H) < 1e-12)
             | (np.abs(pts[:, 2]) < 1e-12) | (np.abs(pts[:, 2] - H) < 1e-12)
             | (np.abs(np.hypot(pts[:, 0] - 0.2, pts[:, 1] - 0.2) - 0.05)
                < 1e-12))
    assert fixed[walls].all()
    assert not fixed[outlet & ~walls].any()


def test_cylinder3d_constant_blocks_equal_numpys():
    """The hexahedra's constant element blocks, built by torch's batched
    contraction, equal numpy's einsum loop to rounding."""
    from openifem_tpu_torch.parameters import AllParameters
    from openifem_tpu_torch.solvers.fluid import InsIM
    from case_util import fields
    cfg, mix, _ = _cell()
    fluid = InsIM(channel(0), AllParameters(**fields(cfg, mix, [0, 0])),
                  device="cpu")
    fluid.a_stencil = False
    fluid.setup()
    cu, cp = fluid.cv_u, fluid.cv_p
    f = cfg["fields"]
    nu, gd, rho, dt = (f["viscosity"], f["grad_div"], f["fluid_rho"],
                       f["time_step"])
    NN = np.einsum("ql,qm,cq->clm", cu.N, cu.N, cu.JxW)
    gg = np.einsum("cqlx,cqmx,cq->clm", cu.grad, cu.grad, cu.JxW)
    Auu = np.einsum("clm,ab->clamb", nu * gg + (rho / dt) * NN, np.eye(3))
    Auu = Auu + gd * rho * np.einsum("cqla,cqmb,cq->clamb", cu.grad,
                                     cu.grad, cu.JxW)
    Aup = -np.einsum("cqla,qn,cq->clan", cu.grad, cp.N, cu.JxW)
    A = fluid._A_const.numpy()
    n_c = A.shape[0]
    assert np.abs(A[:, :81, :81] - Auu.reshape(n_c, 81, 81)).max() \
        <= 1e-13 * np.abs(Auu).max()
    assert np.abs(A[:, :81, 81:] - Aup.reshape(n_c, 81, 8)).max() \
        <= 1e-13 * np.abs(Aup).max()
    assert np.abs(A[:, 81:, :81] - np.swapaxes(Aup.reshape(n_c, 81, 8), 1,
                                               2)).max() \
        <= 1e-13 * np.abs(Aup).max()


def test_cylinder3d_pressure_vcycle():
    """The pressure V-cycle over the 3-D hierarchy (refine 0 and 1, eight
    children a cell): one cycle takes most of a pressure-Laplacian
    residual away."""
    from openifem_tpu_torch.la.multigrid import make_pressure_mg
    mg = make_pressure_mg([channel(0), channel(1)], None, 2, torch.float64,
                          device="cpu")
    fine = mg.levels[-1]
    assert fine.n == channel(1).n_vertices
    b = torch.randn(fine.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))
    b = b - b.mean()            # the pure-Neumann Laplacian's range
    r = b - fine.matvec(mg.vcycle(b))
    assert torch.linalg.vector_norm(r) < 0.5 * torch.linalg.vector_norm(b)


def test_cylinder3d_cell_knobs_take_the_stencil_and_the_vcycle():
    """At refine 1 with the cell's knobs the preconditioner takes the 3-D
    stencil A-solve and one pressure V-cycle as Sm^-1, and the tables
    the knobs ask for are float32."""
    from configs import dfg_cylinder_3d as config
    cfg, mix, draw = _cell(refine=1)
    mix["knobs"].pop("a_stencil")
    fluid = config.Case(cfg, mix, draw, "cpu").fluid
    assert fluid.n_dofs == 185998
    assert fluid.a_solve_branch(fluid.u_constraints) == "stencil"
    assert fluid.sm_solve_branch() == "vcycle"
    assert len(fluid._pressure_mg.levels) == 2
    assert fluid._A_const.dtype == torch.float32
    assert fluid._pressure_mg.levels[-1].A_loc.dtype == torch.float32


def test_cylinder3d_stencil_equals_the_element_operator():
    """The 3-D stencil (125 points, 3 x 3 blocks) applies the velocity
    block as the element node-block matvec does."""
    from openifem_tpu_torch.la.operators import element_matvec_nodeblock
    from openifem_tpu_torch.la.stencil import PatchGrid, StencilOperator
    from openifem_tpu_torch.parameters import AllParameters
    from openifem_tpu_torch.solvers.fluid import InsIM
    from case_util import fields
    cfg, mix, _ = _cell()
    m = generators.flow_around_cylinder(3)
    fluid = InsIM(m, AllParameters(**fields(cfg, mix, [0, 0])),
                  device="cpu")
    fluid.setup()
    grid = PatchGrid.build(m)
    assert grid is not None
    st = StencilOperator(grid, fluid.u_space, d=3, device="cpu")
    n_c, nu = m.n_cells, fluid.nu_loc
    Auu = torch.randn(n_c, nu, nu, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3))
    Ab = Auu.reshape(n_c, 27, 3, 27, 3)
    x = torch.randn(fluid.n_u, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    want = element_matvec_nodeblock(Ab, fluid.cell_nodes_u, fluid.n_u // 3,
                                    x)
    got = st.flat_matvec(st.build_weights(Ab), x)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-10)
