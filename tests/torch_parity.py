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
from openifem_tpu.solvers.fluid.scnsex import SCnsEX as JaxSCnsEX
from openifem_tpu.solvers.fluid.supg import SCnsIM as JaxSCnsIM
from openifem_tpu.solvers.fluid.supg import SerialSCnsIM as JaxSerialSCnsIM
from openifem_tpu.solvers.fluid.supg import SUPGInsIM as JaxSUPGInsIM
from openifem_tpu.fsi.mpi_fsi import MPIFSI as JaxMPIFSI
from openifem_tpu.fsi.cv_fsi import ControlVolumeFSI as JaxControlVolumeFSI
from openifem_tpu.solvers.turbulence import \
    make_turbulence_model as jax_make_turbulence_model
from openifem_tpu.solvers import solid as jax_solid
from openifem_tpu_torch import interop
from openifem_tpu_torch.cases import fsi_disc
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
                      InsIMEX=JaxInsIMEX, SUPGInsIM=JaxSUPGInsIM,
                      SCnsIM=JaxSCnsIM, SerialSCnsIM=JaxSerialSCnsIM,
                      SCnsEX=JaxSCnsEX, FSI=JaxFSI, MPIFSI=JaxMPIFSI,
                      ControlVolumeFSI=JaxControlVolumeFSI,
                      make_turbulence_model=jax_make_turbulence_model,
                      **{name: getattr(jax_solid, name)
                         for name in jax_solid.__all__})
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


# -- the SUPG family (test_torch_supg*.py) ---------------------------------

SUPG_SOLVERS = ("SUPGInsIM", "SCnsIM", "SerialSCnsIM")


def supg_fields(n_steps=3, dt=1e-2):
    """A small channel for the SUPG family: water-like fluid driven by a
    moving top wall and a pressure on the inlet."""
    never = 1e9
    return dict(
        simulation_type="Fluid", dimension=2, global_refinements=[0, 0],
        end_time=n_steps * dt, time_step=dt, output_interval=never,
        refinement_interval=never, save_interval=never,
        gravity=[0.0, -9.8], fluid_velocity_degree=1,
        fluid_pressure_degree=1, viscosity=0.5, fluid_rho=1.2,
        solid_rho=3.0, fluid_max_iterations=8, fluid_tolerance=1e-6,
        n_fluid_dirichlet_bcs=2,
        fluid_dirichlet_bcs={2: (3, [0.0, 0.0]), 3: (3, [1.0, 0.0])},
        n_fluid_neumann_bcs=1, fluid_neumann_bcs={0: 2.0})


def supg_mesh(generators, local=True, nx=6, ny=4):
    """A 2 x 0.4 channel; with `local`, cells left of x = 0.7 are refined
    once (hanging nodes, still brick-structured)."""
    mesh = generators.subdivided_hyper_rectangle([nx, ny], [0.0, 0.0],
                                                 [2.0, 0.4])
    if local:
        mesh = mesh.refine(mesh.cell_centers()[:, 0] < 0.7)
    return mesh


def _body_force(points):
    out = np.zeros_like(points)
    out[:, 0] = 3.0 * np.sin(2.0 * points[:, 1])
    return out


def _sigma_pml(points):
    return np.where(points[:, 0] > 1.5, 40.0 * (points[:, 0] - 1.5) ** 2,
                    0.0)


def supg_solver(port, solver="SCnsIM", local=True, fields=None, mesh=None,
                forces=True, **knobs):
    """A set-up SUPG-family solver of either package on the small channel
    (the port's on the CPU), with a body force and a PML field unless
    `forces` is False; knobs are class attributes set before setup."""
    pkg = PORT if port else JAX
    p = pkg.AllParameters(**(fields or supg_fields()))
    mesh = mesh(pkg.generators) if mesh else supg_mesh(pkg.generators,
                                                       local)
    fl = getattr(pkg, solver)(mesh, p, **(dict(device="cpu") if port
                                          else {}))
    for k, v in knobs.items():
        setattr(fl, k, v)
    if forces:
        fl.set_body_force(_body_force)
        fl.set_sigma_pml_field(_sigma_pml)
    fl.setup()
    return fl


def sa_solver(port, solver="SCnsIM", n_steps=3, **kw):
    """supg_solver's channel with a Spalart-Allmaras model attached and set
    up: inflow on the inlet (id 0), walls on the floor and the moving top
    (ids 2, 3), initial coefficient 3."""
    fields = supg_fields(n_steps)
    fields.update(n_spalart_allmaras_model_bcs=3,
                  spalart_allmaras_model_bcs={0: 1, 2: 0, 3: 0},
                  spalart_allmaras_initial_condition_coefficient=3.0)
    fl = supg_solver(port, solver, fields=fields, **kw)
    pkg = PORT if port else JAX
    pkg.make_turbulence_model("Spalart-Allmaras", fl).setup()
    return fl


def supg_seed_state(jfl, pfl, seed=5, scale=0.3):
    """Give both solvers the same seeded mid-run state (solution, nodal
    stress, indicator, nodal FSI fields); returns the seeded eddy
    viscosity as a numpy array."""
    rng = np.random.default_rng(seed)
    n_n, d = jfl.u_space.n_nodes, jfl.dim
    jfl.present_solution = jfl.nonzero_constraints.distribute(
        jnp.asarray(scale * rng.normal(size=jfl.n_dofs)))
    jfl.stress_device = jnp.asarray(0.1 * rng.normal(size=(n_n, d, d)))
    jfl.indicator = jnp.asarray(
        (rng.random(jfl.mesh.n_cells) < 0.2).astype(float))
    jfl.fsi_acc_nodal = jnp.asarray(rng.normal(size=(n_n, d)))
    jfl.fsi_stress_nodal = jnp.asarray(rng.normal(size=(n_n, d, d)))
    interop.load_fluid_state(pfl, interop.fluid_state(jfl))
    return 1e-2 * rng.normal(size=n_n)


def supg_args(fl, eval_pt, eddy, port):
    """The argument tuple of _assemble at evaluation point `eval_pt`."""
    conv = torch.as_tensor if port else jnp.asarray
    return (conv(np_(eval_pt)), fl.present_solution, fl.indicator,
            fl.fsi_acc_nodal, fl.fsi_stress_nodal, fl.stress_device,
            conv(eddy))


def closure_vars(fn):
    """The free variables of a closure, by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


def jax_precond_pieces(precond):
    """The ingredients of a JAX SUPG preconditioner, read out of its
    closures: apply_Avp, apply_Apv, Pvv_inverse, Tpp, tpp_M."""
    return closure_vars(closure_vars(precond.stats)["_apply"])


# -- AMR and checkpoints (test_torch_amr.py, test_torch_checkpoint.py) -----

def cavity(port, set_up=True, **kw):
    """The lid-driven cavity's InsIM (cases/fsi_disc.py) in either package
    (the port's on the CPU), set up at its global refinement unless
    set_up is False."""
    pkg = PORT if port else JAX
    p = pkg.AllParameters(**fsi_disc.cavity_fields(**kw))
    fl = pkg.InsIM(pkg.generators.hyper_cube(0.0, 1.0, dim=2), p,
                   **(dict(device="cpu") if port else {}))
    if set_up:
        fl.mesh = fl.mesh.refine_global(p.global_refinements[0])
        fl.setup()
    return fl


def disc_fsi(port, n_steps=3, refine_every=2, save_every=None,
             solid="HyperElasticity"):
    """The disc in the cavity (cases/fsi_disc.py) as an unrun FSI of
    either package (the port's on the CPU)."""
    return fsi_disc.disc_case(PORT if port else JAX, n_steps, refine_every,
                              save_every, solid,
                              device="cpu" if port else None)


def ordered_face_values(face_values):
    """The JAX package's face_values with its arrays in the order of the
    face list it was given (it groups them by local face number; the
    JAX kelly_estimate reads them in list order)."""
    import dataclasses

    def wrapped(space, n_q1d, face_list=None):
        fv = face_values(space, n_q1d, face_list)
        if face_list is None or fv is None:
            return fv
        back = np.argsort(np.argsort([f for _, f in face_list],
                                     kind="stable"))
        return dataclasses.replace(fv, **{
            f.name: getattr(fv, f.name)[back]
            for f in dataclasses.fields(fv)})
    return wrapped


def fix_jax_kelly_order(monkeypatch):
    """Make the JAX package's kelly_estimate pair each face with its own
    neighbour (ordered_face_values), as the port's does."""
    import openifem_tpu.fe.kelly as jax_kelly
    monkeypatch.setattr(jax_kelly, "face_values",
                        ordered_face_values(jax_kelly.face_values))
