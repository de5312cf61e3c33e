"""openifem_tpu_torch: the PyTorch port of openifem_tpu.

Same module tree and names as the JAX package.  Meshes and dof maps are
built on the host with numpy; per-step compute (element assembly, matrix-
free Krylov solves, FSI coupling) runs as eager PyTorch on the device from
config.device(): the CUDA card unless the caller asks for the CPU
(`device="cpu"` or OPENIFEM_DEVICE=cpu); without a card the default
raises.  On a CUDA device the element-block matvec runs through the
hand-written kernel in csrc/element_matvec.cu (la/cuda_ops.py).
"""

from . import config  # noqa: F401
from .parameters import AllParameters

__all__ = ["AllParameters"]
__version__ = "0.1.0"
