"""deal.II-compatible ``.prm`` configuration parser and AllParameters.

Reads the exact parameter grammar of the reference implementation
(reference: source/parameters.cpp:1-659, source/parameters.prm:1-201) so the
reference input files run unchanged:

  subsection Simulation
    set End time = 1e0      # comment
  end

Unknown entries raise; missing entries fall back to the declared defaults,
matching deal.II's ParameterHandler declare-then-parse behaviour.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def _parse_prm_text(text: str) -> Dict[Tuple[str, str], str]:
    """Parse .prm text into {(subsection, key): raw value}."""
    entries: Dict[Tuple[str, str], str] = {}
    stack: List[str] = []
    # deal.II supports line continuation with trailing backslash.
    text = text.replace("\\\n", " ")
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            stack.append(line[len("subsection"):].strip())
        elif low == "end":
            if not stack:
                raise ValueError("Unbalanced 'end' in .prm file")
            stack.pop()
        elif low.startswith("set"):
            body = line[len("set"):].strip()
            if "=" not in body:
                raise ValueError(f"Malformed set line: {raw_line!r}")
            key, value = body.split("=", 1)
            sub = stack[-1] if stack else ""
            entries[(sub, key.strip())] = value.strip()
        else:
            raise ValueError(f"Unrecognized .prm line: {raw_line!r}")
    if stack:
        raise ValueError("Unclosed subsection(s): " + ", ".join(stack))
    return entries


def _doubles(s: str) -> List[float]:
    s = s.strip()
    if not s:
        return []
    return [float(x) for x in re.split(r"[,\s]+", s) if x]


def _ints(s: str) -> List[int]:
    s = s.strip()
    if not s:
        return []
    return [int(x) for x in re.split(r"[,\s]+", s) if x]


@dataclass
class AllParameters:
    """Mirror of Parameters::AllParameters (reference: include/parameters.h:15-194)."""

    # --- Simulation (parameters.cpp:9-73)
    simulation_type: str = "FSI"
    dimension: int = 2
    global_refinements: List[int] = field(default_factory=lambda: [0, 0])
    end_time: float = 1.0
    time_step: float = 1.0
    output_interval: float = 1.0
    refinement_interval: float = 1.0
    save_interval: float = 1.0
    gravity: List[float] = field(default_factory=lambda: [0.0, 0.0])
    initial_velocity: List[float] = field(default_factory=lambda: [0.0, 0.0])
    # --- Fluid FE system (parameters.cpp:78-99)
    fluid_pressure_degree: int = 1
    fluid_velocity_degree: int = 1
    # --- Fluid material (parameters.cpp:104-123)
    viscosity: float = 1e-3
    fluid_rho: float = 1.0
    # --- Fluid solver control (parameters.cpp:128-155)
    grad_div: float = 1.0
    fluid_max_iterations: int = 1
    fluid_tolerance: float = 1e-8
    # --- Fluid Dirichlet BCs (parameters.cpp:160-241): id -> (flag, values)
    use_hard_coded_values: int = 0
    n_fluid_dirichlet_bcs: int = 0
    fluid_dirichlet_bcs: Dict[int, Tuple[int, List[float]]] = field(
        default_factory=dict)
    # --- Fluid Neumann BCs (parameters.cpp:245-287): id -> pressure value
    n_fluid_neumann_bcs: int = 0
    fluid_neumann_bcs: Dict[int, float] = field(default_factory=dict)
    # --- Spalart-Allmaras (parameters.cpp:292-375): id -> type (0 wall/1 inflow)
    n_spalart_allmaras_model_bcs: int = 0
    spalart_allmaras_model_bcs: Dict[int, int] = field(default_factory=dict)
    spalart_allmaras_initial_condition_coefficient: float = 0.0
    wall_function_effective_distance: float = 1.0
    wall_function_image_distance: float = 0.01
    # --- Solid FE system
    solid_degree: int = 1
    # --- Solid material
    solid_type: str = "LinearElastic"
    n_solid_parts: int = 1
    solid_rho: float = 1.0
    E: List[float] = field(default_factory=lambda: [0.0])
    nu: List[float] = field(default_factory=lambda: [0.0])
    eta: List[float] = field(default_factory=lambda: [0.0])
    C: List[List[float]] = field(default_factory=lambda: [[0.0, 0.0]])
    # --- Solid solver control
    damping: float = 0.0
    solid_max_iterations: int = 8
    tol_d: float = 1e-10
    tol_f: float = 1e-10
    contact_force_multiplier: float = 1e8
    # --- Solid Dirichlet BCs: id -> component flag (homogeneous only)
    n_solid_dirichlet_bcs: int = 0
    solid_dirichlet_bcs: Dict[int, int] = field(default_factory=dict)
    # --- Solid Neumann BCs: id -> values
    n_solid_neumann_bcs: int = 0
    solid_neumann_bc_type: str = "Traction"
    solid_neumann_bcs: Dict[int, List[float]] = field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str) -> "AllParameters":
        with open(path) as f:
            return cls.from_text(f.read())

    @classmethod
    def from_text(cls, text: str) -> "AllParameters":
        e = _parse_prm_text(text)
        p = cls()

        def get(sub, key, default):
            return e.get((sub, key), default)

        sub = "Simulation"
        p.simulation_type = get(sub, "Simulation type", "FSI")
        p.dimension = int(get(sub, "Dimension", "2"))
        p.global_refinements = _ints(get(sub, "Global refinements", "0, 0"))
        p.end_time = float(get(sub, "End time", "1.0"))
        p.time_step = float(get(sub, "Time step size", "1.0"))
        p.output_interval = float(get(sub, "Output interval", "1.0"))
        p.refinement_interval = float(get(sub, "Refinement interval", "1.0"))
        p.save_interval = float(get(sub, "Save interval", "1.0"))
        p.gravity = _doubles(get(sub, "Gravity", "0.0, 0.0"))
        p.initial_velocity = _doubles(get(sub, "Initial velocity", "0.0, 0.0"))

        sub = "Fluid finite element system"
        p.fluid_pressure_degree = int(get(sub, "Pressure degree", "1"))
        p.fluid_velocity_degree = int(get(sub, "Velocity degree", "1"))

        sub = "Fluid material properties"
        p.viscosity = float(get(sub, "Dynamic viscosity", "1e-3"))
        p.fluid_rho = float(get(sub, "Fluid density", "1.0"))

        sub = "Fluid solver control"
        p.grad_div = float(get(sub, "Grad-Div stabilization", "1.0"))
        p.fluid_max_iterations = int(get(sub, "Max Newton iterations", "1"))
        p.fluid_tolerance = float(get(sub, "Nonlinear system tolerance", "1e-8"))

        sub = "Fluid Dirichlet BCs"
        p.use_hard_coded_values = int(
            get(sub, "Use hard-coded boundary values", "0"))
        p.n_fluid_dirichlet_bcs = int(get(sub, "Number of Dirichlet BCs", "0"))
        ids = _ints(get(sub, "Dirichlet boundary id", ""))
        flags = _ints(get(sub, "Dirichlet boundary components", ""))
        values = _doubles(get(sub, "Dirichlet boundary values", ""))
        # Values are packed per-boundary with 1/2/3 entries depending on the
        # component flag (reference: parameters.cpp:208-239).
        n = 0
        p.fluid_dirichlet_bcs = {}
        for i in range(p.n_fluid_dirichlet_bcs):
            flag = flags[i]
            cnt = 1 if flag in (1, 2, 4) else (2 if flag in (3, 5, 6) else 3)
            p.fluid_dirichlet_bcs[ids[i]] = (flag, values[n:n + cnt])
            n += cnt

        sub = "Fluid Neumann BCs"
        p.n_fluid_neumann_bcs = int(get(sub, "Number of Neumann BCs", "0"))
        ids = _ints(get(sub, "Neumann boundary id", ""))
        values = _doubles(get(sub, "Neumann boundary values", ""))
        p.fluid_neumann_bcs = {
            ids[i]: values[i] for i in range(p.n_fluid_neumann_bcs)
        }

        sub = "Spalart Allmaras model"
        p.n_spalart_allmaras_model_bcs = int(
            get(sub, "Number of S-A model BCs", "0"))
        ids = _ints(get(sub, "S-A model boundary id", ""))
        types = _ints(get(sub, "S-A model boundary types", ""))
        p.spalart_allmaras_model_bcs = {
            ids[i]: types[i] for i in range(p.n_spalart_allmaras_model_bcs)
        }
        p.spalart_allmaras_initial_condition_coefficient = float(
            get(sub, "Initial condition coefficient", "0.0"))
        p.wall_function_effective_distance = float(
            get(sub, "Wall function effective distance", "1.0"))
        p.wall_function_image_distance = float(
            get(sub, "Wall function image distance", "0.01"))

        sub = "Solid finite element system"
        p.solid_degree = int(get(sub, "Degree", "1"))

        sub = "Solid material properties"
        p.solid_type = get(sub, "Solid type", "LinearElastic")
        p.n_solid_parts = int(get(sub, "Number of solid parts", "1"))
        p.solid_rho = float(get(sub, "Solid density", "1.0"))
        p.E = _doubles(get(sub, "Young's modulus", "0.0"))
        p.nu = _doubles(get(sub, "Poisson's ratio", "0.0"))
        p.eta = _doubles(get(sub, "Viscosity", "0.0"))
        if len(p.eta) < p.n_solid_parts:
            p.eta = p.eta + [0.0] * (p.n_solid_parts - len(p.eta))
        raw_C = _doubles(get(sub, "Hyperelastic parameters", ""))
        # NeoHookean consumes (C1, kappa) per part; extra trailing entries in
        # the input are ignored (reference: parameters.cpp:497-516).
        size_per_material = 2 if p.solid_type == "NeoHookean" else 1
        p.C = []
        for i in range(p.n_solid_parts):
            chunk = raw_C[i * size_per_material:(i + 1) * size_per_material]
            if len(chunk) < size_per_material:
                chunk = chunk + [0.0] * (size_per_material - len(chunk))
            p.C.append(chunk)

        sub = "Solid solver control"
        p.damping = float(get(sub, "Damping", "0.0"))
        p.solid_max_iterations = int(get(sub, "Max Newton iterations", "8"))
        p.tol_d = float(get(sub, "Displacement tolerance", "1e-10"))
        p.tol_f = float(get(sub, "Force tolerance", "1e-10"))
        p.contact_force_multiplier = float(
            get(sub, "Contact force multiplier", "1e8"))

        sub = "Solid Dirichlet BCs"
        p.n_solid_dirichlet_bcs = int(get(sub, "Number of Dirichlet BCs", "0"))
        ids = _ints(get(sub, "Dirichlet boundary id", ""))
        flags = _ints(get(sub, "Dirichlet boundary components", ""))
        p.solid_dirichlet_bcs = {
            ids[i]: flags[i] for i in range(p.n_solid_dirichlet_bcs)
        }

        sub = "Solid Neumann BCs"
        p.n_solid_neumann_bcs = int(get(sub, "Number of Neumann BCs", "0"))
        ids = _ints(get(sub, "Neumann boundary id", ""))
        p.solid_neumann_bc_type = get(sub, "Neumann boundary type", "Traction")
        values = _doubles(get(sub, "Neumann boundary values", ""))
        per = p.dimension if p.solid_neumann_bc_type == "Traction" else 1
        p.solid_neumann_bcs = {
            ids[i]: values[i * per:(i + 1) * per]
            for i in range(p.n_solid_neumann_bcs)
        }
        return p


def component_flag_to_mask(flag: int, dim: int) -> List[bool]:
    """Decode the 1-7 component flag (binary zyx) into a per-axis mask.

    Reference: source/fluid_solver.cpp:88-130, source/solid_solver.cpp:61-76.
    """
    mask = [bool(flag & 1), bool(flag & 2), bool(flag & 4)]
    return mask[:dim]


def component_flag_values(flag: int, values: List[float],
                          dim: int) -> List[float]:
    """Expand packed BC values into a per-axis list (zeros where unmasked)."""
    mask = component_flag_to_mask(flag, dim)
    out = [0.0] * dim
    k = 0
    for d in range(dim):
        if mask[d]:
            out[d] = values[k]
            k += 1
    return out
