"""Build, bind and launch the hand-written CUDA element-matvec kernel.

Counterpart of openifem_tpu/la/pallas_ops.py.  The kernel source is
csrc/element_matvec.cu (plain C interface, no PyTorch headers).  It is
compiled with nvcc for sm_90a at first use into openifem_tpu_torch/_build/
and loaded with ctypes; the library name carries a hash of the source, so
an edited kernel is rebuilt.  Nothing CUDA-specific happens at import.

`launch` is the only place the kernel runs.  It checks what it is given,
allocates the zero-filled output, launches on PyTorch's current stream,
raises if cudaGetLastError() is not 0, and counts the launch in
`launches` under (layout, dtype name, number of cells), so that a caller
can tell which shapes a run launched.  la/operators.py calls it for CUDA
tensors; there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "element_matvec.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# warps (= cells) per thread block; must match kWarpsPerBlock in the source
_WARPS_PER_BLOCK = 4
# the kernel stages one cell's gathered x per warp in dynamic shared memory
_SMEM_LIMIT = 48 * 1024

LAYOUTS = ("element_matvec", "element_matvec_rect",
           "element_matvec_nodeblock", "element_matvec_u_to_p_nodeblock",
           "element_matvec_p_to_u_nodeblock", "element_matvec_taylor_hood")
# launches of the kernel, per (layout, dtype name, number of cells)
launches = Counter()

_LIB = None
_LOCK = threading.Lock()
build_seconds = None


def reset_launches():
    launches.clear()


def _nvcc():
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cand:
        p = os.path.join(root, "bin", "nvcc") if root else ""
        if p and os.path.exists(p):
            return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA element-matvec kernel "
                           "cannot be built on this machine")
    return p


def library_path():
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"element_matvec_{digest}.so")


def build(verbose: bool = False):
    """Compile the kernel library if it is not built yet; returns its path.
    Sets `build_seconds` to the compile time (0.0 when it was cached)."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        if build_seconds is None:
            build_seconds = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build the element-matvec "
                           f"kernel:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(proc.stdout + proc.stderr)
    return out


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
            for fn in (lib.element_matvec_f64, lib.element_matvec_f32):
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check_table(name, t, n_c, width, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != (n_c, width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(n_c, width)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(layout: str, A, cell_stride: int, row_stride: int, rows, cols,
           n_out: int, x, nr: int, nc: int, dr: int = 1, dc: int = 1):
    """y (n_out,) with y[rows[c, i//dr]*dr + i%dr] +=
    sum_k A[c, i, k] x[cols[c, k//dc]*dc + k%dc].

    A: a tensor whose storage holds each cell's (nr, nc) block at
    A.data_ptr() + c*cell_stride + i*row_stride + k (in elements)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout}")
    if not x.is_cuda:
        raise ValueError("the CUDA element matvec takes CUDA tensors only")
    dev = x.device
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if A.dtype != x.dtype:
        raise TypeError(f"A is {A.dtype} but x is {x.dtype}")
    if A.device != dev:
        raise ValueError(f"A is on {A.device}, x on {dev}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    if nr % dr or nc % dc or dr < 1 or dc < 1:
        raise ValueError(f"component widths ({dr}, {dc}) do not divide "
                         f"the block ({nr}, {nc})")
    n_c = A.shape[0]
    _check_table("rows", rows, n_c, nr // dr, dev)
    _check_table("cols", cols, n_c, nc // dc, dev)
    if row_stride < nc or cell_stride < 0:
        raise ValueError(f"strides ({cell_stride}, {row_stride}) do not "
                         f"describe ({nr}, {nc}) blocks")
    span = (n_c - 1) * cell_stride + (nr - 1) * row_stride + nc
    if n_c and A.storage_offset() + span > A.untyped_storage().nbytes() \
            // A.element_size():
        raise ValueError("A's strides reach past its storage")
    if _WARPS_PER_BLOCK * nc * x.element_size() > _SMEM_LIMIT:
        raise ValueError(f"block width {nc} exceeds the kernel's shared "
                         "memory")
    y = torch.zeros(n_out, dtype=x.dtype, device=dev)
    lib = _lib()
    fn = lib.element_matvec_f64 if x.dtype == torch.float64 else \
        lib.element_matvec_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(A.data_ptr(), cell_stride, row_stride, rows.data_ptr(),
            cols.data_ptr(), x.data_ptr(), y.data_ptr(), n_c, nr, nc, dr,
            dc, stream)
    if rc != 0:
        raise RuntimeError(f"element-matvec kernel launch failed "
                           f"({layout}): cudaError {rc}")
    launches[(layout, str(x.dtype).replace("torch.", ""), n_c)] += 1
    return y
