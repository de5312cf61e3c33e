"""Native (C++) host-side kernels, loaded via ctypes.

Compiled on first use from native/mesh_kernels.cpp (g++ -O3); every entry
point has a pure-Python fallback, so the framework runs without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_repo_root(), "native", "mesh_kernels.cpp")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_mesh_kernels.so")
    try:
        if (not os.path.exists(out) or
                os.path.getmtime(out) < os.path.getmtime(src)):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", src, "-o", out],
                check=True, capture_output=True)
        lib = ctypes.CDLL(out)
        lib.build_cell_dofs.restype = ctypes.c_int64
        lib.build_cell_dofs.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.face_occurrences.restype = None
        lib.face_occurrences.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
    except Exception as e:  # pragma: no cover - compiler missing
        print(f"[openifem_tpu_torch.native] falling back to Python kernels: {e}",
              file=sys.stderr)
        _LIB = None
    return _LIB


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def build_cell_dofs(cells: np.ndarray, dim: int, degree: int,
                    n_vertices: int):
    """Returns (cell_dofs (n_c, (degree+1)**dim) int64, n_nodes) or None."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    n_c = len(cells)
    nl = (degree + 1) ** dim
    out = np.empty((n_c, nl), dtype=np.int64)
    n_nodes = lib.build_cell_dofs(_ptr(cells, ctypes.c_int64), n_c, dim,
                                  degree, n_vertices,
                                  _ptr(out, ctypes.c_int64))
    return out, int(n_nodes)


def face_occurrences(cells: np.ndarray, dim: int):
    """(n_c, 2*dim) int32 face-sharing counts (1 = boundary), or None."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    out = np.empty((len(cells), 2 * dim), dtype=np.int32)
    lib.face_occurrences(_ptr(cells, ctypes.c_int64), len(cells), dim,
                         _ptr(out, ctypes.c_int32))
    return out
