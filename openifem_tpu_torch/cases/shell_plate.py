"""The flat-shell cases, built in code: a clamped square plate under a
uniform transverse pressure and an axial bar (the closed-form checks of
the JAX package's tests/test_shell.py:28-60; OpenIFEM's own
tests/solid_shell_plate runs the optional libMesh shell library, whose
goldens are not in the repository).

  plate  a = 1 square, E = 1e4, nu = 0.3, thickness 0.02, q = 1, all four
         edges clamped (flag 7): Kirchhoff's centre deflection
         w_c = 0.00126 q a^4 / D, D = E t^3 / (12 (1 - nu^2));
  bar    1 x 0.25, E = 1e4, nu = 0, thickness 0.05, in-plane load f = 2,
         the left edge clamped: tip displacement u = f a^2 / (2 E t).

This module uses only numpy, so the JAX package and the PyTorch port build
the same configuration.

    python -m openifem_tpu_torch.cases.shell_plate [cells] [--device cpu]

solves the plate at cells x cells (default 64: 4,225 nodes, 21,125 dofs)
and prints the centre deflection against Kirchhoff's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

CASES = {
    "plate": dict(E=1.0e4, nu=0.3, thickness=0.02, size=(1.0, 1.0),
                  bcs={0: 7, 1: 7, 2: 7, 3: 7}, load=(0.0, 0.0, 1.0)),
    "bar": dict(E=1.0e4, nu=0.0, thickness=0.05, size=(1.0, 0.25),
                bcs={0: 7}, load=(2.0, 0.0, 0.0)),
}


def shell_case(pkg, case: str = "plate", cells=(16, 16), device=None):
    """An unsolved ShellSolidSolver of `case` (one of CASES) on a
    cells[0] x cells[1] mesh, built with the classes of `pkg` (a
    namespace with AllParameters, generators and ShellSolidSolver of
    either package; cases.fsi_leaflet.port_package() gives the port's).
    device: the port's torch device (leave None for the JAX package)."""
    c = CASES[case]
    p = pkg.AllParameters()
    p.E, p.nu, p.solid_degree = [c["E"]], [c["nu"]], 1
    p.solid_dirichlet_bcs = dict(c["bcs"])
    mesh = pkg.generators.subdivided_hyper_rectangle(list(cells), [0, 0],
                                                     list(c["size"]))
    kw = {} if device is None else dict(device=device)
    shell = pkg.ShellSolidSolver(mesh, p, thickness=c["thickness"], **kw)
    load = np.asarray(c["load"])
    shell.set_surface_load(lambda pts: np.tile(load, (len(pts), 1)))
    return shell


def closed_form(case: str = "plate") -> float:
    """Kirchhoff's plate centre deflection, or the bar's tip
    displacement."""
    c = CASES[case]
    E, nu, t = c["E"], c["nu"], c["thickness"]
    a = c["size"][0]
    if case == "plate":
        D = E * t ** 3 / (12 * (1 - nu ** 2))
        return 0.00126 * c["load"][2] * a ** 4 / D
    return c["load"][0] * a ** 2 / (2 * E * t)


def measured(shell, case: str = "plate") -> float:
    """The solution's counterpart of closed_form: the largest transverse
    (plate) or axial (bar) displacement."""
    u = shell.get_current_solution()
    u = np.asarray(u.cpu() if hasattr(u, "cpu") else u).reshape(-1, 3)
    return float(u[:, 2 if case == "plate" else 0].max())


def main():
    from .fsi_leaflet import port_package
    ap = argparse.ArgumentParser(description="clamped plate, flat shell")
    ap.add_argument("cells", nargs="?", type=int, default=64)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    shell = shell_case(port_package(), "plate", (args.cells, args.cells),
                       device=args.device)
    t0 = time.perf_counter()
    shell.run()
    seconds = time.perf_counter() - t0
    w, ref = measured(shell), closed_form()
    print(f"plate {args.cells} x {args.cells} ({shell.n_dofs} dofs): "
          f"w_c {w:.6e} against Kirchhoff {ref:.6e} "
          f"({100 * (w - ref) / ref:+.2f} %), {shell.cg_iters} CG "
          f"iterations, {seconds:.2f} s")


if __name__ == "__main__":
    main()
