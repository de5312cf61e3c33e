"""Build, bind and launch the hand-written CUDA kernels: the element
matvec and the stencil apply.

Counterpart of openifem_tpu/la/pallas_ops.py.  The kernel sources are
csrc/element_matvec.cu and csrc/stencil_apply.cu (plain C interfaces, no
PyTorch headers).  They are compiled with nvcc for sm_90a at first use
into one library under openifem_tpu_torch/_build/ and loaded with ctypes;
the library name carries a hash of both sources, so an edited kernel is
rebuilt.  Nothing CUDA-specific happens at import.

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
cells, block rows, block columns), so that a caller can tell which shapes
a run launched, and at a key's first launch notes in `launch_sizes` what
a launch of it moves (a reader computes its bytes from them).  A
replayed CUDA graph (la/krylov.py BlockGraphs) launches without calling
it: BlockGraphs takes a capture's counts back out and adds them on every
replay, so `launches` holds what ran.  la/operators.py calls it for CUDA
tensors; there is no fallback to the plain version.  `emulate` is the kernel's index arithmetic in plain
PyTorch, for the tests.

`stencil_apply` launches the stencil kernel on one brick group of
la/stencil.py's StencilOperator (its `matvec` calls it for CUDA tensors;
la/stencil.py's `emulate_stencil_apply` is its plain twin with the
kernel's tiling).  It checks its arguments per call, counts the launch in
`launches` under ("stencil_apply", dtype name, bricks, bordered grid, k,
d_out, d_in), and at a key's first launch notes in `stencil_sizes` (never
in `launch_sizes`, whose readers bound element-matvec launches) what one
launch moves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from collections import Counter

import torch

from ..utils.timer import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "element_matvec.cu")
STENCIL_SOURCE = os.path.join(_PKG, "csrc", "stencil_apply.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAYOUTS = ("element_matvec", "element_matvec_rect",
           "element_matvec_nodeblock", "element_matvec_u_to_p_nodeblock",
           "element_matvec_p_to_u_nodeblock", "element_matvec_taylor_hood")
# the widest block row the kernel takes (kMaxSteps * 32 in the source)
MAX_COLUMNS = 256
# launches of the kernel, per (layout, dtype name, number of cells, block
# rows, block columns)
launches = Counter()
# what a launch of each key of `launches` moves, noted at the key's first
# launch (set-up and graph captures included, and kept through
# reset_launches): cells, nr, nc, the element size of A, the entries of
# the index tables it reads (rows, and cols where it is another table) and
# their element size, x's entries and element size, and n_out
launch_sizes = {}
# what one stencil launch of each ("stencil_apply", ...) key of `launches`
# moves, noted at the key's first launch: the group's bricks n_b, cells m
# and nodes G per axis, k, d_out, d_in and the element sizes of W and x
stencil_sizes = {}
# gather plans built (one per index table and row count)
plan_builds = 0

_DTYPES = {torch.float64: ("element_matvec_f64", "float64"),
           torch.float32: ("element_matvec_f32", "float32")}
_STENCIL_DTYPES = {torch.float64: ("stencil_apply_f64", "float64"),
                   torch.float32: ("stencil_apply_f32", "float32")}
# component counts and degrees the stencil kernel takes
STENCIL_MAX_COMPONENTS = 4
STENCIL_DEGREES = (1, 2, 3)
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
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return p


def library_path():
    digest = hashlib.sha1()
    for src in (SOURCE, STENCIL_SOURCE):
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"kernels_{digest.hexdigest()[:12]}.so")


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
        + ["-o", tmp, SOURCE, STENCIL_SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build the kernels:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(proc.stdout + proc.stderr)
    return out


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            with span("kernel_load"):
                lib = ctypes.CDLL(build())
                argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p] + [ctypes.c_int] * 7 + \
                    [ctypes.c_void_p]
                for name, _ in _DTYPES.values():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
                for name, _ in _STENCIL_DTYPES.values():
                    fn = getattr(lib, name)
                    fn.argtypes = [p, ll, ll, ll, p, ll, p, ll] + [i] * 8 \
                        + [p]
                    fn.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def _cached(t, key, make, others=()):
    """make() once per (table tensor, key) while the tensor is unchanged:
    the cache lives on the tensor and is keyed by its version counter,
    which every in-place write advances.  `others`: more tables the value
    depends on, held by weak reference and version."""
    cache = t.__dict__.setdefault("_element_matvec_cache", {})
    key = (t._version,) + tuple((id(o), o._version) for o in others) + key
    hit = cache.get(key)
    if hit is None or any(r() is not o for r, o in zip(hit[0], others)):
        with span("plan_build"):
            hit = cache[key] = ([weakref.ref(o) for o in others], make())
    return hit[1]


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
    key = (layout, dt_name, n_c, nr, nc)
    launches[key] += 1
    if key not in launch_sizes:
        launch_sizes[key] = dict(
            cells=n_c, nr=nr, nc=nc, a_elem_bytes=A.element_size(),
            table_numel=rows.numel() + (0 if cols is rows else cols.numel()),
            table_elem_bytes=rows.element_size(), x_numel=x.numel(),
            x_elem_bytes=x.element_size(), n_out=n_out)
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


def stencil_geometry(gp, k):
    """(cells m, nodes G) per axis of a brick group whose bordered grid is
    `gp` (G = k m + 1, gp = G + 2 k); raises unless gp is such a grid."""
    G = tuple(int(g) - 2 * k for g in gp)
    m = tuple((n - 1) // k for n in G)
    if any(c < 1 or k * c + 1 != n for c, n in zip(m, G)):
        raise ValueError(f"{tuple(gp)} is not the bordered grid of a "
                         f"degree-{k} brick")
    return m, G


def check_stencil_args(W, x, y, base, gp, k):
    """Raise unless stencil_apply takes these arguments (any device);
    returns (n_b, M, d_out, d_in)."""
    dim = len(gp)
    if dim not in (2, 3):
        raise ValueError(f"the stencil kernel takes 2-D and 3-D bricks, "
                         f"not {dim}-D")
    if k not in STENCIL_DEGREES:
        raise ValueError(f"the stencil kernel takes k in {STENCIL_DEGREES}"
                         f", not {k}")
    stencil_geometry(gp, k)
    M = 1
    for g in gp:
        M *= int(g)
    if W.dim() != 5 or W.shape[0] != (2 * k + 1) ** dim or W.shape[4] != M:
        raise ValueError(f"W has shape {tuple(W.shape)}, expected "
                         f"({(2 * k + 1) ** dim}, d_out, d_in, n_b, {M})")
    d_out, d_in, n_b = W.shape[1], W.shape[2], W.shape[3]
    for name, n in (("d_out", d_out), ("d_in", d_in)):
        if not 1 <= n <= STENCIL_MAX_COMPONENTS:
            raise ValueError(f"{name} {n} is outside [1, "
                             f"{STENCIL_MAX_COMPONENTS}]")
    if W.stride(4) != 1 or (n_b > 1 and W.stride(3) != M):
        raise ValueError("each (n_b, M) plane of W must be contiguous")
    if x.dtype not in _STENCIL_DTYPES:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    for name, t in (("W", W), ("y", y)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t, d in (("x", x, d_in), ("y", y, d_out)):
        if t.dim() != 2 or t.shape[0] != d or t.stride(1) != 1:
            raise ValueError(f"{name} must be ({d}, slots) with contiguous "
                             f"rows, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
        if base < 0 or base + n_b * M > t.shape[1]:
            raise ValueError(f"{name} has {t.shape[1]} slots; the group "
                             f"takes [{base}, {base + n_b * M})")
    extent = sum((n - 1) * st for n, st in zip(W.shape, W.stride())) + 1
    if W.numel() and W.storage_offset() + extent > \
            W.untyped_storage().nbytes() // W.element_size():
        raise ValueError("W's strides reach past its storage")
    return n_b, M, d_out, d_in


def stencil_apply(W, x, y, base: int, gp, k: int):
    """One brick group of a structured-patch stencil apply: with
    M = prod(gp) slots per brick and s over the (2k+1)^dim offsets,

        y[a, base + b*M + m] = sum_{s, c} W[s, a, c, b, m]
                               * x[c, base + b*M + m + off(s) - F]

    at a brick's interior slots (k or more from each face of its
    bordered grid `gp`) and exactly 0 at its border slots.  W must be zero
    on the border rows and wherever it couples two nodes of no common
    cell, as StencilOperator.build_weights leaves it: the kernel reads
    only the other entries (la/stencil.py::coupling_mask).  W:
    (S^dim, d_out, d_in, n_b, M), any
    strides over its first three axes, contiguous (n_b, M) planes; x:
    (d_in, slots), y: (d_out, slots), rows contiguous.  Writes the
    group's slots of y (no zero fill needed) with one launch on PyTorch's
    current stream and returns y."""
    if not x.is_cuda:
        raise ValueError("the CUDA stencil apply takes CUDA tensors only")
    n_b, M, d_out, d_in = check_stencil_args(W, x, y, base, gp, k)
    fn_name, dt_name = _STENCIL_DTYPES[x.dtype]
    g = (1,) * (3 - len(gp)) + tuple(int(n) for n in gp)
    es = x.element_size()
    rc = getattr(_lib(), fn_name)(
        W.data_ptr(), W.stride(0), W.stride(1), W.stride(2),
        x.data_ptr() + base * es, x.stride(0), y.data_ptr() + base * es,
        y.stride(0), n_b, len(gp), *g, k, d_out, d_in,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil-apply kernel launch failed: cudaError "
                           f"{rc}")
    key = ("stencil_apply", dt_name, n_b, tuple(int(n) for n in gp), k,
           d_out, d_in)
    launches[key] += 1
    if key not in stencil_sizes:
        m, G = stencil_geometry(gp, k)
        stencil_sizes[key] = dict(n_b=n_b, m=m, G=G, k=k, d_out=d_out,
                                  d_in=d_in, w_elem_bytes=W.element_size(),
                                  x_elem_bytes=es)
    return y
