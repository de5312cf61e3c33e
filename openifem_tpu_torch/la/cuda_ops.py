"""Build, bind and launch the hand-written CUDA element-matvec kernel.

Counterpart of openifem_tpu/la/pallas_ops.py.  The kernel source is
csrc/element_matvec.cu (plain C interface, no PyTorch headers).  It is
compiled with nvcc for sm_90a at first use into openifem_tpu_torch/_build/
and loaded with ctypes; the library name carries a hash of the source, so
an edited kernel is rebuilt.  Nothing CUDA-specific happens at import.

The kernel is owner-computes: it reads the gather plan of the row table
(la/operators.py::make_gather_plan) and writes each output once, so it
needs no zero fill and no atomics, and one apply is one launch.

`launch` is the only place the kernel runs.  What holds for the life of an
index table (shape, int32, contiguity, device, index range, K) is checked
once, when the table's plan is built; the plan is cached on the table
tensor, keyed by its version counter, so a new or changed table gets a new
plan and `plan_builds` counts the builds.  Per call, `launch` checks A's
dtype, device and storage span and x's dtype, device, shape and
contiguity, allocates y with torch.empty, makes one ctypes call on
PyTorch's current stream, raises if the kernel returned an error, and
counts the launch in `launches` under (layout, dtype name, number of
cells), so that a caller can tell which shapes a run launched.
la/operators.py calls it for CUDA tensors; there is no fallback to the
plain version.  `emulate` is the kernel's index arithmetic in plain
PyTorch, for the tests.
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

LAYOUTS = ("element_matvec", "element_matvec_rect",
           "element_matvec_nodeblock", "element_matvec_u_to_p_nodeblock",
           "element_matvec_p_to_u_nodeblock", "element_matvec_taylor_hood")
# the widest block row the kernel takes (kMaxSteps * 32 in the source)
MAX_COLUMNS = 256
# launches of the kernel, per (layout, dtype name, number of cells)
launches = Counter()
# gather plans built (one per index table and row count)
plan_builds = 0

_DTYPES = {torch.float64: ("element_matvec_f64", "float64"),
           torch.float32: ("element_matvec_f32", "float32")}
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
                        ctypes.c_void_p, ctypes.c_void_p] + \
                [ctypes.c_int] * 7 + [ctypes.c_void_p]
            for name, _ in _DTYPES.values():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _cached(t, key, make):
    """make() once per (table tensor, key) while the tensor is unchanged:
    the cache lives on the tensor and is keyed by its version counter,
    which every in-place write advances."""
    cache = t.__dict__.setdefault("_element_matvec_cache", {})
    key = (t._version,) + key
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _check_table(name, t, width, n_entities, device):
    """Raise unless t is a contiguous int32 (n_cells, width) table on
    `device` with entries in [0, n_entities) (n_entities None: any
    non-negative entry); returns its largest entry (-1 when empty)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"(n_cells, {width})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() == 0:
        return -1
    lo, hi = int(t.min()), int(t.max())
    if lo < 0 or (n_entities is not None and hi >= n_entities):
        raise ValueError(f"{name} has entries in [{lo}, {hi}], outside "
                         f"[0, {n_entities})")
    return hi


def _row_plan(rows, n_out, nr, dr, device):
    """(plan, K, n_flat) for the row table: checked and built once."""
    if nr % dr or n_out % dr:
        raise ValueError(f"row component width {dr} does not divide the "
                         f"block rows {nr} or the output size {n_out}")

    def make():
        global plan_builds
        from .operators import make_gather_plan   # operators imports us
        _check_table("rows", rows, nr // dr, n_out // dr, device)
        if rows.numel() >= 2 ** 31:
            raise ValueError("rows has more than 2**31 entries")
        plan = make_gather_plan(rows, n_out // dr)
        plan_builds += 1
        return plan, plan.shape[1], rows.numel()
    return _cached(rows, ("plan", n_out, nr, dr), make)


def _col_max(cols, nc, dc, device):
    """The largest column entity of the column table: checked once."""
    if nc % dc:
        raise ValueError(f"column component width {dc} does not divide "
                         f"the block columns {nc}")
    if nc > MAX_COLUMNS:
        raise ValueError(f"blocks of {nc} columns exceed the kernel's "
                         f"{MAX_COLUMNS}")
    return _cached(cols, ("cols", nc, dc), lambda: _check_table(
        "cols", cols, nc // dc, None, device))


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
    plan, K, n_flat = _row_plan(rows, n_out, nr, dr, dev)
    col_max = _col_max(cols, nc, dc, dev)
    # per call: what can change between applies
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if A.dtype != x.dtype:
        raise TypeError(f"A is {A.dtype} but x is {x.dtype}")
    if A.device != dev:
        raise ValueError(f"A is on {A.device}, x on {dev}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    if x.shape[0] < (col_max + 1) * dc:
        raise ValueError(f"x has {x.shape[0]} entries; the column table "
                         f"reaches entry {(col_max + 1) * dc - 1}")
    n_c = A.shape[0]
    if n_c != rows.shape[0] or n_c != cols.shape[0]:
        raise ValueError(f"A has {n_c} cells, the tables {rows.shape[0]} "
                         f"and {cols.shape[0]}")
    if row_stride < nc or cell_stride < 0:
        raise ValueError(f"strides ({cell_stride}, {row_stride}) do not "
                         f"describe ({nr}, {nc}) blocks")
    span = (n_c - 1) * cell_stride + (nr - 1) * row_stride + nc
    if n_c and A.storage_offset() + span > A.untyped_storage().nbytes() \
            // A.element_size():
        raise ValueError("A's strides reach past its storage")
    fn_name, dt_name = _DTYPES[x.dtype]
    y = torch.empty(n_out, dtype=x.dtype, device=dev)
    rc = getattr(_lib(), fn_name)(
        A.data_ptr(), cell_stride, row_stride, cols.data_ptr(),
        plan.data_ptr(), x.data_ptr(), y.data_ptr(), n_out, K, n_flat, nr,
        nc, dr, dc, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"element-matvec kernel launch failed "
                           f"({layout}): cudaError {rc}")
    launches[(layout, dt_name, n_c)] += 1
    return y


def emulate(layout: str, A, cell_stride: int, row_stride: int, rows, cols,
            n_out: int, x, nr: int, nc: int, dr: int = 1, dc: int = 1):
    """What `launch` computes, in plain PyTorch on any device, with the
    kernel's indexing: the owner of output r = e*dr + a walks the plan row
    of entity e; incidence p = c*(nr/dr) + j gives local row j*dr + a of
    cell c, read at c*cell_stride + i*row_stride + k from A's storage."""
    from .operators import make_gather_plan
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout}")
    n_c, per_cell = A.shape[0], nr // dr
    plan = make_gather_plan(rows, n_out // dr).long()    # (n_out/dr, K)
    r = torch.arange(n_out, device=x.device)
    p = plan[r // dr]                                    # (n_out, K)
    valid = p < rows.numel()                             # not the sentinel
    p = torch.where(valid, p, 0)
    c = p // per_cell
    i = (p - c * per_cell) * dr + (r % dr)[:, None]
    k = torch.arange(nc, device=x.device)
    span = (n_c - 1) * cell_stride + (nr - 1) * row_stride + nc
    flat_A = torch.as_strided(A, (max(span, 0),), (1,))
    A_rows = flat_A[(c * cell_stride + i * row_stride)[..., None] + k]
    col = cols.reshape(-1).long()[c[..., None] * (nc // dc) + k // dc]
    prod = A_rows * x[col * dc + k % dc]                 # (n_out, K, nc)
    return torch.where(valid[..., None], prod, 0).sum(dim=(1, 2))
