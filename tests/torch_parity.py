"""Shared builders for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Both packages build the same configuration in code from
openifem_tpu_torch.cases.fsi_leaflet (numpy only); data moves between
them as numpy arrays.  JAX stays on the CPU (tests/conftest.py).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import openifem_tpu
from openifem_tpu.fsi import FSI as JaxFSI
from openifem_tpu.mesh import generators as jax_generators
from openifem_tpu.solvers.fluid import InsIM as JaxInsIM
from openifem_tpu.solvers.fluid import InsIMEX as JaxInsIMEX
from openifem_tpu.solvers.solid import HyperElasticity as JaxHyper
from openifem_tpu_torch import interop
from openifem_tpu_torch.cases.fsi_leaflet import leaflet_case, port_package

# the tests run several workers at once; one thread each is as fast at
# these sizes
torch.set_num_threads(1)
# the port runs on the card unless asked for the CPU: these tests ask, for
# every solver and operator that a test builds without a device argument
os.environ["OPENIFEM_DEVICE"] = "cpu"

# the coarse leaflet: 4,324 fluid + 54 solid dofs
COARSE = dict(h=0.1, refinements=(0, 1))


# the JAX package's classes, in the form leaflet_case takes a package
JAX = SimpleNamespace(AllParameters=openifem_tpu.AllParameters,
                      generators=jax_generators, InsIM=JaxInsIM,
                      InsIMEX=JaxInsIMEX, HyperElasticity=JaxHyper,
                      FSI=JaxFSI)
PORT = port_package()


def leaflet_fsi(port: bool, n_steps=3, h=0.1, refinements=(0, 1),
                config="element", **kw):
    """An unrun FSI of the leaflet case in either package (the element-
    matvec configuration unless `config` says otherwise); the port's on
    the CPU."""
    if port:
        kw.setdefault("device", "cpu")
    return leaflet_case(PORT if port else JAX, config, h=h,
                        refinements=refinements, n_steps=n_steps, **kw)


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


def run_pair(n_steps=3, **kw):
    """Run the same leaflet configuration through FSI.run in both
    packages: ((JAX fsi, Newton log), (port fsi, Newton log))."""
    runs = []
    for port in (False, True):
        fsi = leaflet_fsi(port, n_steps=n_steps, **kw)
        log = record_newton(fsi)
        fsi.run(verbose=False)
        runs.append((fsi, log))
    return runs


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


# -- one preconditioner apply in both packages (test_torch_precond_*) ------

# inner solves to convergence: one apply is then the preconditioner's
# linear map (test_torch_precond_branches.py says why)
TIGHT = dict(mp_sm_rtol=1e-13, a_inner_rtol=1e-12)
# the r2-style configuration at test size: uniform channel, 2 levels
R2_SMALL = dict(config="fsi_leaflet_r2", h=0.2, extra_refine=1)


def mg_enabler(kind):
    """fn(fsi) attaching a V-cycle over the case's hierarchy (after
    setup): "pressure" as FSI.run does, "pressure_galerkin", "velocity"
    (Galerkin) or "velocity_geo"."""
    def enable(fsi):
        fl, meshes = fsi.fluid, fsi.fluid_mg_base + [fsi.fluid.mesh]
        if kind == "pressure":
            fsi._enable_fluid_mg()
        elif kind == "pressure_galerkin":
            fl.enable_pressure_mg(meshes, galerkin=True)
        elif kind == "velocity":
            fl.enable_velocity_mg(meshes)
        else:
            fl.enable_velocity_mg(meshes, galerkin=False)
    return enable


def precond_pair(case_kw, knobs, enable):
    """(JAX fluid, port fluid) set up with the same knobs, hierarchy and
    seeded mid-run state."""
    kw = dict(dict(bench_precision=False), **case_kw)
    out = []
    for port in (False, True):
        fsi = leaflet_fsi(port, n_steps=1, **kw)
        for k, v in knobs.items():
            setattr(fsi.fluid, k, v)
        setup_fsi(fsi)
        if enable is not None:
            enable(fsi)
        out.append(fsi.fluid)
    jfl, pfl = out
    rng = np.random.default_rng(11)
    jfl.present_solution = jfl.nonzero_constraints.distribute(
        jnp.asarray(0.2 * rng.normal(size=jfl.n_dofs)))
    interop.load_fluid_state(pfl, interop.fluid_state(jfl))
    return jfl, pfl


def precond_apply(fl, v, port):
    """One apply of fl's preconditioner, built from the Newton matrix at
    its present solution: (output, (mp, sm, a) inner iterations)."""
    args = (fl.present_solution, fl.present_solution, fl.indicator,
            fl.fsi_acceleration, fl.fsi_stress_cell, fl.fsi_acc_nodal)
    A_loc, _ = fl._assemble(*args)
    P = fl._make_preconditioner(A_loc, fl.u_constraints, fl.p_constraints)
    if not port:
        out, its = jax.jit(P.stats)(jnp.asarray(v))
        return np.asarray(out), tuple(int(i) for i in its)
    k0 = dict(fl.krylov_iters)
    out = P(torch.as_tensor(v))
    return out, tuple(fl.krylov_iters[k] - k0[k] for k in ("mp", "sm", "a"))


def precond_check(case_kw, knobs, enable, a_branch, sm_branch):
    """Apply both packages' preconditioners to one seeded vector: the
    port's branch must be (a_branch, sm_branch).  Returns (relative error,
    JAX inner iterations, port inner iterations)."""
    jfl, pfl = precond_pair(case_kw, knobs, enable)
    v = np.random.default_rng(12).normal(size=pfl.n_dofs)
    ref, jits = precond_apply(jfl, v, False)
    got, pits = precond_apply(pfl, v, True)
    assert list(pfl.precond_branches) == [(a_branch, sm_branch)]
    return rel_err(got, ref), jits, pits
