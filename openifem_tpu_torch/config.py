"""Numerical configuration of the PyTorch port.

The JAX package turns on x64 globally (openifem_tpu/config.py), so every
solver state of the port is float64 by default.  The dtype and device are
passed explicitly to every tensor constructor; the port never changes
PyTorch's global default dtype.

Matrix products are computed in full precision on every device: importing
the package turns TF32 off for float32 products and makes bfloat16
products accumulate in float32 (`full_precision_products`).  The dense
Sm GEMM, the float32 GEMVs, the bf16 A-block GEMV and the float32
Newton-Schulz coarse inverse then compute on CUDA what they compute on
the CPU, whichever entry point runs them.

Environment:
  OPENIFEM_X64=0        run the solver state in float32
  OPENIFEM_DEVICE=...   torch device for solver state (default "cpu")
"""

import os

import torch

_X64 = os.environ.get("OPENIFEM_X64", "1") != "0"
_DEVICE = torch.device(os.environ.get("OPENIFEM_DEVICE", "cpu"))


def full_precision_products():
    """No TF32 in float32 products; float32 accumulation of bfloat16
    products (PyTorch's flags are process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


full_precision_products()

# index tables handed to the element-matvec kernel are int32
index_dtype = torch.int32


def real_dtype():
    """The floating dtype used for all solver state."""
    return torch.float64 if _X64 else torch.float32


def device():
    """The torch device that holds solver state."""
    return _DEVICE

