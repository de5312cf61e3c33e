"""The yardstick's table of peaks and the byte count of an element-matvec
launch.

Frozen from chip_smoke.py at commit 2573dc3: HBM_BYTES_PER_S and
PEAK_FLOPS (chip_smoke.py:238-239) and `_bound` (chip_smoke.py:397-411),
which counts each byte of A, the index tables, x and y once.  The peaks
are those of NVIDIA's data sheet for the H100 SXM at its full 700 W (the
float32 and float64 rates outside the tensor cores)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


def dt_name(dt):
    return str(dt).replace("torch.", "")


def launch_bound(A, rows, cols, x, n_out, nr, nc):
    """(least seconds, bytes) of one element-matvec launch: A, the index
    tables it reads, x and y each moved once, against 2 nr nc flops per
    cell."""
    n_c = A.shape[0]
    tables = [rows] + ([cols] if cols is not rows else [])
    nbytes = (n_c * nr * nc * A.element_size()
              + sum(t.numel() * t.element_size() for t in tables)
              + (x.numel() + n_out) * x.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n_c * nr * nc / PEAK_FLOPS[dt_name(x.dtype)]
    return max(t_bytes, t_ops), nbytes
