from .hyper import HyperElasticity
from .hypo import HypoElasticity, SharedHypoElasticity
from .linear import LinearElasticity
from .shared import SharedHyperElasticity, SharedLinearElasticity
from .shell import ShellSolidSolver

__all__ = ["LinearElasticity", "HyperElasticity", "HypoElasticity",
           "SharedHypoElasticity", "SharedLinearElasticity",
           "SharedHyperElasticity", "ShellSolidSolver"]
