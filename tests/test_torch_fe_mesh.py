"""The port's copied host layer (mesh, FE spaces, FE values) builds the same
tables as openifem_tpu on the leaflet mesh at the reference size
(h = 0.05: fluid refined 0 times, solid 2 times): cell and dof tables,
hanging-node tables, boundary maps and FE values, equal exactly."""

import numpy as np
import pytest

from openifem_tpu.fe import fevalues as jfev
from openifem_tpu.fe import space as jspace
from openifem_tpu.mesh import generators as jax_generators
from openifem_tpu_torch.cases.fsi_leaflet import leaflet_meshes
from openifem_tpu_torch.fe import fevalues as fev
from openifem_tpu_torch.fe import space
from openifem_tpu_torch.mesh import generators

MESH_FIELDS = ("vertices", "cells", "material_id", "boundary_id", "level")


@pytest.fixture(scope="module")
def meshes():
    jf, js = leaflet_meshes(jax_generators, 0.05)
    pf, ps = leaflet_meshes(generators, 0.05)
    return {"fluid": (jf, pf), "solid": (js.refine_global(2),
                                         ps.refine_global(2))}


@pytest.mark.parametrize("which", ["fluid", "solid"])
def test_mesh_tables_equal(meshes, which):
    jm, pm = meshes[which]
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f), f)
    np.testing.assert_array_equal(pm.cell_centers(), jm.cell_centers())
    if which == "fluid":
        assert pm.n_cells == 1780 and np.unique(pm.level).size == 2
    else:
        assert pm.n_cells == 256


@pytest.mark.parametrize("which,degree", [("fluid", 2), ("fluid", 1),
                                          ("solid", 1)])
def test_space_tables_equal(meshes, which, degree):
    jm, pm = meshes[which]
    js, ps = jspace.FESpace(jm, degree), space.FESpace(pm, degree)
    assert ps.n_nodes == js.n_nodes
    np.testing.assert_array_equal(ps.cell_dofs, js.cell_dofs)
    np.testing.assert_array_equal(ps.node_points, js.node_points)
    jb, pb = js.boundary_node_map(), ps.boundary_node_map()
    assert sorted(pb) == sorted(jb)
    for bid in jb:
        np.testing.assert_array_equal(pb[bid], jb[bid])
    jcv, pcv = jfev.cell_values(js, degree + 1), fev.cell_values(ps,
                                                                 degree + 1)
    for f in ("N", "grad", "JxW", "xq"):
        np.testing.assert_array_equal(getattr(pcv, f), getattr(jcv, f), f)
    jfv, pfv = jfev.face_values(js, degree + 1), fev.face_values(ps,
                                                                 degree + 1)
    for f in ("cells", "faces", "boundary_id", "N", "JxW", "normals"):
        np.testing.assert_array_equal(getattr(pfv, f), getattr(jfv, f), f)


def test_system_tables_and_dof_count(meshes):
    """The Q2^2 x Q1 fluid system with its hanging-node tables, and the
    reference size of 17,249 dofs (fluid 16,655 + solid 594)."""
    (jf, pf), (js, ps) = meshes["fluid"], meshes["solid"]
    jsys = jspace.SystemSpace([(jspace.FESpace(jf, 2), 2),
                               (jspace.FESpace(jf, 1), 1)])
    psys = space.SystemSpace([(space.FESpace(pf, 2), 2),
                              (space.FESpace(pf, 1), 1)])
    np.testing.assert_array_equal(psys.cell_dofs, jsys.cell_dofs)
    for a, b in zip(psys.hanging_tables(), jsys.hanging_tables()):
        np.testing.assert_array_equal(a, b)
    assert psys.hanging_tables()[2].any()
    solid_sys = space.SystemSpace([(space.FESpace(ps, 1), 2)])
    assert psys.n_dofs == 16655 and solid_sys.n_dofs == 594
    assert psys.n_dofs + solid_sys.n_dofs == 17249
