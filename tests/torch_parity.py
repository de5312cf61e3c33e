"""Shared builders for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Both packages build the same configuration in code from
openifem_tpu_torch.cases.fsi_leaflet (numpy only); data moves between
them as numpy arrays.  JAX stays on the CPU (tests/conftest.py).
"""

import numpy as np
import torch

import openifem_tpu
import openifem_tpu_torch
from openifem_tpu.fsi import FSI as JaxFSI
from openifem_tpu.mesh import generators as jax_generators
from openifem_tpu.solvers.fluid import InsIM as JaxInsIM
from openifem_tpu.solvers.solid import HyperElasticity as JaxHyper
from openifem_tpu_torch.cases.fsi_leaflet import (inflow, leaflet_fields,
                                                  leaflet_meshes)
from openifem_tpu_torch.fsi import FSI
from openifem_tpu_torch.mesh import generators
from openifem_tpu_torch.solvers.fluid import InsIM
from openifem_tpu_torch.solvers.solid import HyperElasticity

# the tests run several workers at once; one thread each is as fast at
# these sizes
torch.set_num_threads(1)

# the coarse leaflet: 4,324 fluid + 54 solid dofs
COARSE = dict(h=0.1, refinements=(0, 1))


def params(pkg, n_steps=3, h=0.1, refinements=(0, 1)):
    return pkg.AllParameters(**leaflet_fields(h=h, refinements=refinements,
                                              n_steps=n_steps))


def leaflet_fsi(port: bool, n_steps=3, h=0.1, refinements=(0, 1)):
    """An unrun FSI of the leaflet case in either package."""
    if port:
        p = params(openifem_tpu_torch, n_steps, h, refinements)
        fm, sm = leaflet_meshes(generators, h)
        return FSI(InsIM(fm, p, bc=inflow), HyperElasticity(sm, p), p,
                   use_dirichlet_bc=True)
    p = params(openifem_tpu, n_steps, h, refinements)
    fm, sm = leaflet_meshes(jax_generators, h)
    fluid = JaxInsIM(fm, p, bc=inflow)
    fluid.a_stencil = False
    return JaxFSI(fluid, JaxHyper(sm, p), p, use_dirichlet_bc=True)


def setup_fsi(fsi):
    """The set-up part of FSI.run: refine, set up both solvers, coupling."""
    gr = fsi.params.global_refinements
    fsi.solid.mesh = fsi.solid.mesh.refine_global(gr[1])
    fsi.solid.setup()
    fsi.fluid.mesh = fsi.fluid.mesh.refine_global(gr[0])
    fsi.fluid.setup()
    fsi._setup_coupling()
    return fsi


def record_newton(fsi):
    """Log (solid, fluid) Newton counts after every step of fsi.run."""
    log = []
    run_fluid, run_coupled = fsi._run_fluid_step, fsi.run_one_coupled_step

    def fluid_step(*a, **k):
        run_fluid(*a, **k)
        log.append((int(fsi.solid.newton_iters), int(fsi.fluid.newton_iters)))

    def coupled_step(*a, **k):
        run_coupled(*a, **k)
        log.append((int(fsi.solid.newton_iters), int(fsi.fluid.newton_iters)))

    fsi._run_fluid_step = fluid_step
    fsi.run_one_coupled_step = coupled_step
    return log


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_err(got, ref):
    """max |got - ref| relative to the reference's max norm."""
    got, ref = np_(got), np_(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / (scale if scale > 0 else 1.0))
