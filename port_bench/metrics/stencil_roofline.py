"""The stencil kernel's share of its roofline over the traced segment, in
%: for each ("stencil_apply", ...) key launched in the profiled replay
(graph replays included), its launches times the least time of one
launch, summed, over the summed device time of the kernels whose name
contains stencil_apply.

The least time of a launch is its bytes at peaks.HBM_BYTES_PER_S or its
flops at peaks.PEAK_FLOPS, whichever is longer, from the sizes the program
notes at the key's first launch (openifem_tpu_torch/la/cuda_ops.py
stencil_sizes).  Bytes: the structurally non-zero coefficients of the
brick group, n_b * prod_t N(k, m_t) * d_out * d_in at W's element size,
where N(k, m) = m (k+1)^2 - (m - 1) counts the (node, offset) pairs of an
axis of m cells whose nodes share a cell, plus x and y at the group's
nodes, (d_in + d_out) * n_b * prod_t G_t at x's.  Any implementation has
to move these, so the count does not depend on the kernel's layout.
Flops: two per non-zero coefficient.  A program without the table of
sizes gives None."""

import math

import peaks

KERNEL = "stencil_apply"


def nonzero_pairs(k, m):
    """N(k, m): (node, offset) pairs along one axis of m degree-k cells
    whose two nodes share a cell."""
    return m * (k + 1) ** 2 - (m - 1)


def least_seconds(key, sizes):
    """(least seconds, bytes) of one launch of `key` ("stencil_apply",
    dtype name, ...) with the noted `sizes`."""
    nz = sizes["n_b"] * sizes["d_out"] * sizes["d_in"] * math.prod(
        nonzero_pairs(sizes["k"], m) for m in sizes["m"])
    nbytes = (nz * sizes["w_elem_bytes"]
              + (sizes["d_in"] + sizes["d_out"]) * sizes["n_b"]
              * math.prod(sizes["G"]) * sizes["x_elem_bytes"])
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               2 * nz / peaks.PEAK_FLOPS[key[1]]), nbytes


def program_sizes():
    """The program's table of stencil launch sizes, or None where the
    program has none."""
    try:
        from openifem_tpu_torch.la import cuda_ops
    except ImportError:
        return None
    return getattr(cuda_ops, "stencil_sizes", None)


def read(ctx):
    sizes = program_sizes()
    if not sizes:
        return None
    bound = sum(n * least_seconds(key, sizes[key])[0]
                for key, n in ctx["launches"].items()
                if key[0] == KERNEL and key in sizes)
    device = sum(s for name, s in ctx["trace"]["by_name"].items()
                 if KERNEL in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
