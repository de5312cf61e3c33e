from .checkpoint import load_latest_checkpoint, save_checkpoint
from .vtk import write_vtu

__all__ = ["write_vtu", "save_checkpoint", "load_latest_checkpoint"]
