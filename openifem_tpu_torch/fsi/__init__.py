from .fsi import FSI
from .mpi_fsi import MPIFSI

__all__ = ["FSI", "MPIFSI"]
