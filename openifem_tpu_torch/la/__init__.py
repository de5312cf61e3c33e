from .constraints import Constraints
from .operators import ElementOperator, element_matvec, scatter_add
from .krylov import cg, fgmres

__all__ = [
    "Constraints", "ElementOperator", "element_matvec", "scatter_add", "cg",
    "fgmres",
]
