"""Numerical configuration of the PyTorch port.

The JAX package turns on x64 globally (openifem_tpu/config.py), so every
solver state of the port is float64 by default.  The dtype and device are
passed explicitly to every tensor constructor; the port never changes
PyTorch's global default dtype.

Environment:
  OPENIFEM_X64=0        run the solver state in float32
  OPENIFEM_DEVICE=...   torch device for solver state (default "cpu")
"""

import os

import torch

_X64 = os.environ.get("OPENIFEM_X64", "1") != "0"
_DEVICE = torch.device(os.environ.get("OPENIFEM_DEVICE", "cpu"))

# index tables handed to the element-matvec kernel are int32
index_dtype = torch.int32


def real_dtype():
    """The floating dtype used for all solver state."""
    return torch.float64 if _X64 else torch.float32


def device():
    """The torch device that holds solver state."""
    return _DEVICE

