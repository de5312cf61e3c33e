from .constraints import Constraints
from .operators import element_matvec, scatter_add
from .krylov import cg, fgmres

__all__ = ["Constraints", "element_matvec", "scatter_add", "cg", "fgmres"]
