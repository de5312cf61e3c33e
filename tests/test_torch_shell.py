"""The port's ShellSolidSolver against the JAX package and against the
closed forms of the JAX package's tests/test_shell.py (the cases of
openifem_tpu_torch/cases/shell_plate.py, built in code, on the CPU):

- the element stiffness blocks, the rhs and the constraint mask within
  1e-12;
- the displacement and the rotations within 1e-8, and a CG count under
  the 20 n_dofs cap (the JAX solve runs inside jit and keeps no count);
- the clamped plate's centre deflection within 4 % of Kirchhoff's, and
  the axial bar's tip within 2 %, in-plane and transverse parts decoupled.
"""

import numpy as np
import pytest

from openifem_tpu_torch.cases import shell_plate as sp
from torch_parity import JAX, PORT, np_, rel_err


@pytest.fixture(scope="module", params=["plate", "bar"])
def pair(request):
    case = request.param
    cells = (16, 16) if case == "plate" else (16, 4)
    out = []
    for pkg, kw in ((JAX, {}), (PORT, dict(device="cpu"))):
        shell = sp.shell_case(pkg, case, cells, **kw)
        shell.run()
        out.append(shell)
    return case, out


def test_tables(pair):
    _, (js, ps) = pair
    assert ps.K_loc.shape == (ps.mesh2.n_cells, 20, 20)
    assert rel_err(ps.K_loc, js.K_loc) <= 1e-12
    assert rel_err(ps.rhs, js.rhs) <= 1e-12
    np.testing.assert_array_equal(np_(ps.constraints.fixed),
                                  np.asarray(js.constraints.fixed))
    np.testing.assert_array_equal(np_(ps.cell_dofs),
                                  np.asarray(js.cell_dofs))


def test_displacement(pair):
    _, (js, ps) = pair
    assert rel_err(ps.get_current_solution(), js.get_current_solution()) \
        <= 1e-8
    assert rel_err(ps.rotations, np.asarray(js.rotations)) <= 1e-8
    assert 0 < ps.cg_iters < 20 * ps.n_dofs


def test_shell_clamped_plate_uniform_pressure():
    shell = sp.shell_case(PORT, "plate", (16, 16), device="cpu")
    shell.run()
    w_c, w_ref = sp.measured(shell, "plate"), sp.closed_form("plate")
    assert abs(w_c - w_ref) / w_ref < 0.04, (w_c, w_ref)
    # in-plane displacements vanish for pure bending of a flat plate
    disp = np_(shell.get_current_solution()).reshape(-1, 3)
    assert np.abs(disp[:, :2]).max() < 1e-10 * w_c + 1e-14


def test_shell_membrane_axial_bar():
    shell = sp.shell_case(PORT, "bar", (16, 4), device="cpu")
    shell.run()
    u_tip, u_ref = sp.measured(shell, "bar"), sp.closed_form("bar")
    assert abs(u_tip - u_ref) / u_ref < 0.02, (u_tip, u_ref)
    disp = np_(shell.get_current_solution()).reshape(-1, 3)
    assert np.abs(disp[:, 2]).max() < 1e-10 * u_tip + 1e-14
