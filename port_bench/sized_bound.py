"""The least time of one element-matvec launch from the sizes the program
notes at a shape's first launch (openifem_tpu_torch/la/cuda_ops.py
launch_sizes), by peaks.py's formula and constants: A, the index tables,
x and y each moved once at the HBM rate, or the flops at the peak of the
launch's dtype, whichever takes longer.  The program computes no bytes;
this file counts them."""

from __future__ import annotations

import peaks


def launch_bytes(sizes):
    """Bytes one launch moves: A's blocks, the index tables, x and y."""
    return (sizes["cells"] * sizes["nr"] * sizes["nc"] * sizes["a_elem_bytes"]
            + sizes["table_numel"] * sizes["table_elem_bytes"]
            + (sizes["x_numel"] + sizes["n_out"]) * sizes["x_elem_bytes"])


def least_seconds(key, sizes):
    """(least seconds, bytes) of one launch of `key` (layout, dtype name,
    cells, block rows, block columns) with the noted `sizes`."""
    nbytes = launch_bytes(sizes)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = 2 * sizes["cells"] * sizes["nr"] * sizes["nc"] \
        / peaks.PEAK_FLOPS[key[1]]
    return max(t_bytes, t_ops), nbytes


def program_sizes():
    """The program's table of launch sizes, or None where the program has
    none."""
    try:
        from openifem_tpu_torch.la import cuda_ops
    except ImportError:
        return None
    return getattr(cuda_ops, "launch_sizes", None)
