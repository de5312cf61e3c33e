from .cv_fsi import ControlVolumeFSI
from .fsi import FSI
from .mpi_fsi import MPIFSI

__all__ = ["ControlVolumeFSI", "FSI", "MPIFSI"]
