// Structured-patch stencil apply for Hopper (sm_90a): one kernel for every
// brick group of la/stencil.py's StencilOperator.
//
// Replaces no Pallas kernel.  The JAX package's stencil apply
// (openifem_tpu/la/stencil.py::StencilOperator.matvec) is XLA ops: a
// broadcast multiply of the coefficients with S^dim shifted windows of the
// input, then two sums.  Ported as it was, that writes a product as large
// as the coefficients and reads it back; at the 3-D cylinder's refinement
// 2 (832 bricks of 13^3 slots, 125 offsets, 3 x 3 blocks, f32) that is
// 8.2 GB of coefficients, 8.2 GB of product written and read: about
// 16 ms an apply, 90 % of the card's time in the cell.  This kernel
// computes
//
//   y[a, b, m] = sum_{s, c} W[s, a, c, b, m] * x[c, b, m + off(s) - F]
//
// in registers and writes y once.  off(s) = sum_t s_t * stride_t over the
// bordered brick grid (axis 0 slowest, the last axis contiguous) and
// F = k * sum_t stride_t, so offset s = (k, ..., k) is the slot itself.
//
// What bounds it: bytes.  Each coefficient is used once (2 flops per 4 or
// 8 B), so the least time is the structurally non-zero coefficients, x and
// y moved once at 3.35 TB/s: at the 3-D refinement 2, 1.09 GB, 0.33 ms.
//
// Design, for that bound:
// - W is zero wherever it couples two nodes of no common cell
//   (StencilOperator.build_weights sums element blocks, so only the nodes
//   of one cell couple), and on a brick's k-wide border rows.  Each
//   thread tests, per axis, which of its S offsets reach a node of a
//   common cell (`coupled`) and loads only those coefficients: a border
//   slot loads nothing and writes an exact 0, and a block whose tile is
//   all border only writes its zeros.  In a 3-D Q2 z-order patch that
//   leaves 33^3 (offset, node) pairs of the 125 x 13^3 (offset, slot)
//   pairs; they are read once, in 32 B sectors that also hold the
//   neighbours skipped along the last axis, and no product is written.
//   Measured on the H100 at the 3-D cell's group in f32: the border test
//   alone 1.83 ms, the per-axis test 1.37 ms (256-slot tiles).
// - A block takes a tile of kThreads consecutive slots of one brick (one
//   thread a slot), so bricks of any size tile the grid, and stages the
//   window [m0 - F, m0 + kThreads + F) of each input component in shared
//   memory once; each output reads its S^dim inputs from there.  Where
//   that window would not fit in kMaxStagedBytes (large 3-D lattice
//   bricks), the threads read x from device memory instead, through the
//   same index arithmetic.
// - The coefficient planes (n_b, M) are contiguous, so a warp's load of
//   one (s, a, c) entry is one coalesced segment along M; the S loads
//   along the last axis are independent (d_out * d_in * S in flight).
// - Each thread keeps one sum per (a, c) in registers and adds them over
//   c in order at the end: a fixed order per output, so every run gives
//   the same bits.  Sums are taken in the tensors' type.
// Dimension 2 is dimension 3 with one plane along axis 0 (no border, one
// offset), so one kernel takes both; k (S = 2k + 1), d_out and d_in (1 to
// 4) are template parameters, W's (s, a, c) strides are arguments (a
// component slice of a built stencil is a strided view).
// Not used, and why: tensor cores (wgmma) -- no coefficient is reused, so
// there is no product for them; TMA -- the interior rows are 9 to 37
// slots, and the border columns between them are what the kernel skips.

#include <cuda_runtime.h>

namespace {

// slots a block takes, one a thread (STENCIL_TILE in la/stencil.py's
// emulation); measured on the H100 at the 3-D cell's group, f32: 256
// slots 1.37 ms, 128 slots 1.29 ms
constexpr int kThreads = 128;
// the staged window's limit: the shared memory a block gets without
// an opt-in
constexpr int kMaxStagedBytes = 48 * 1024;

struct Geometry {
  int M;           // slots per brick
  int g0, g1, g2;  // bordered extents (g0 = 1 in 2-D)
  int st0, st1;    // strides of axes 0 and 1; axis 2 is contiguous
  int k0, k;       // border width along axis 0 (0 in 2-D) and the others
  int S0;          // offsets along axis 0 (1 in 2-D)
  int F;           // k0 * st0 + k * st1 + k
  int tiles;       // tiles per brick
  int L;           // window length per component
  bool staged;     // the window sits in shared memory
};

// Bit s set where offset s - k along one axis of n nodes (interior node
// coordinate j, degree k, S offsets) reaches a node that shares a cell
// with node j: within the brick, and at most k - (j mod k) up or
// k - (-j mod k) down (a vertex node reaches k both ways, a node inside a
// cell only that cell's nodes).
__device__ __forceinline__ int coupled(int j, int n, int k, int S) {
  const int up = k - j % k, down = k - (k - j % k) % k;
  int mask = 0;
  for (int s = 0; s < S; ++s) {
    const int o = s - (S - 1) / 2;
    const bool ok = j + o >= 0 && j + o < n && (o > 0 ? o <= up : -o <= down);
    mask |= static_cast<int>(ok) << s;
  }
  return mask;
}

template <typename T, int S, int DO, int DI>
__global__ void __launch_bounds__(kThreads) stencil_apply_kernel(
    const T* __restrict__ W, long long ws, long long wa, long long wc,
    const T* __restrict__ x, long long xc, T* __restrict__ y,
    long long ya, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  const int b = blockIdx.x / g.tiles;
  const int m0 = (blockIdx.x - b * g.tiles) * kThreads;
  const int m = m0 + threadIdx.x;
  const long long plane = (long long)b * g.M;

  const int i0 = m / g.st0;
  const int i1 = (m - i0 * g.st0) / g.st1;
  const int i2 = m - i0 * g.st0 - i1 * g.st1;
  const bool inside = m < g.M && i0 >= g.k0 && i0 < g.g0 - g.k0 &&
                      i1 >= g.k && i1 < g.g1 - g.k && i2 >= g.k &&
                      i2 < g.g2 - g.k;
  // block-uniform: a tile that is all border writes its zeros and stops
  if (!__syncthreads_or(inside)) {
    if (m < g.M) {
#pragma unroll
      for (int a = 0; a < DO; ++a) y[a * ya + plane + m] = T(0);
    }
    return;
  }
  // x of component c at offset o (0 <= o < 2F + 1) from slot m - F
  const T* xs;
  long long xstride;
  if (g.staged) {
    for (int c = 0; c < DI; ++c) {
      const T* xcp = x + c * xc + plane;
      for (int i = threadIdx.x; i < g.L; i += kThreads) {
        const int p = m0 - g.F + i;
        win[c * g.L + i] = (p >= 0 && p < g.M) ? __ldg(xcp + p) : T(0);
      }
    }
    __syncthreads();
    xs = win + threadIdx.x;
    xstride = g.L;
  } else {
    xs = x + plane + m - g.F;
    xstride = xc;
  }

  T acc[DO][DI];
#pragma unroll
  for (int a = 0; a < DO; ++a) {
#pragma unroll
    for (int c = 0; c < DI; ++c) acc[a][c] = T(0);
  }
  if (inside) {
    // the offsets along each axis whose node shares a cell with this
    // slot's: the coefficients of the others are zero and are not read
    const int mask0 = coupled(i0 - g.k0, g.g0 - 2 * g.k0, g.k, g.S0);
    const int mask1 = coupled(i1 - g.k, g.g1 - 2 * g.k, g.k, S);
    const int mask2 = coupled(i2 - g.k, g.g2 - 2 * g.k, g.k, S);
    const T* Wm = W + plane + m;
    for (int s0 = 0; s0 < g.S0; ++s0) {
      if (!((mask0 >> s0) & 1)) continue;
#pragma unroll 1
      for (int s1 = 0; s1 < S; ++s1) {
        if (!((mask1 >> s1) & 1)) continue;
        const int row = s0 * g.st0 + s1 * g.st1;
        const T* Wrow = Wm + (long long)((s0 * S + s1) * S) * ws;
#pragma unroll
        for (int s2 = 0; s2 < S; ++s2) {
          if (!((mask2 >> s2) & 1)) continue;
          T xv[DI];
#pragma unroll
          for (int c = 0; c < DI; ++c) xv[c] = xs[c * xstride + row + s2];
          const T* Ws = Wrow + s2 * ws;
#pragma unroll
          for (int a = 0; a < DO; ++a) {
#pragma unroll
            for (int c = 0; c < DI; ++c) {
              acc[a][c] = fma(__ldg(Ws + a * wa + c * wc), xv[c], acc[a][c]);
            }
          }
        }
      }
    }
  }
  if (m < g.M) {
#pragma unroll
    for (int a = 0; a < DO; ++a) {
      T v = acc[a][0];
#pragma unroll
      for (int c = 1; c < DI; ++c) v += acc[a][c];
      y[a * ya + plane + m] = v;
    }
  }
}

template <typename T, int S, int DO, int DI>
void launch_one(const void* W, long long ws, long long wa, long long wc,
                const void* x, long long xc, void* y, long long ya,
                int n_b, const Geometry& g, cudaStream_t stream) {
  const size_t smem = g.staged ? (size_t)g.L * DI * sizeof(T) : 0;
  stencil_apply_kernel<T, S, DO, DI>
      <<<n_b * g.tiles, kThreads, smem, stream>>>(
          static_cast<const T*>(W), ws, wa, wc, static_cast<const T*>(x),
          xc, static_cast<T*>(y), ya, g);
}

template <typename T, int S>
int launch_s(const void* W, long long ws, long long wa, long long wc,
             const void* x, long long xc, void* y, long long ya, int n_b,
             const Geometry& g, int d_out, int d_in, cudaStream_t stream) {
#define OPENIFEM_STENCIL_ARGS W, ws, wa, wc, x, xc, y, ya, n_b, g, stream
#define OPENIFEM_STENCIL_DI(DO_)                                            \
  switch (d_in) {                                                           \
    case 1: launch_one<T, S, DO_, 1>(OPENIFEM_STENCIL_ARGS); break;         \
    case 2: launch_one<T, S, DO_, 2>(OPENIFEM_STENCIL_ARGS); break;         \
    case 3: launch_one<T, S, DO_, 3>(OPENIFEM_STENCIL_ARGS); break;         \
    case 4: launch_one<T, S, DO_, 4>(OPENIFEM_STENCIL_ARGS); break;         \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
  switch (d_out) {
    case 1: OPENIFEM_STENCIL_DI(1); break;
    case 2: OPENIFEM_STENCIL_DI(2); break;
    case 3: OPENIFEM_STENCIL_DI(3); break;
    case 4: OPENIFEM_STENCIL_DI(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef OPENIFEM_STENCIL_DI
#undef OPENIFEM_STENCIL_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* W, long long ws, long long wa, long long wc,
           const void* x, long long xc, void* y, long long ya, int n_b,
           int dim, int g0, int g1, int g2, int k, int d_out, int d_in,
           void* stream_ptr) {
  if ((dim != 2 && dim != 3) || (dim == 2 && g0 != 1) || k < 1 || k > 3 ||
      n_b < 0 || g0 < 1 || g1 <= 2 * k || g2 <= 2 * k ||
      (dim == 3 && g0 <= 2 * k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.g0 = g0;
  g.g1 = g1;
  g.g2 = g2;
  g.st1 = g2;
  g.st0 = g1 * g2;
  g.M = g0 * g.st0;
  g.k = k;
  g.k0 = dim == 3 ? k : 0;
  g.S0 = dim == 3 ? 2 * k + 1 : 1;
  g.F = g.k0 * g.st0 + k * g.st1 + k;
  g.tiles = (g.M + kThreads - 1) / kThreads;
  g.L = kThreads + 2 * g.F;
  const long long blocks = (long long)n_b * g.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const size_t elem = sizeof(T);
  g.staged = (long long)g.L * d_in * elem <= kMaxStagedBytes;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch (2 * k + 1) {
    case 3:
      return launch_s<T, 3>(W, ws, wa, wc, x, xc, y, ya, n_b, g, d_out,
                            d_in, stream);
    case 5:
      return launch_s<T, 5>(W, ws, wa, wc, x, xc, y, ya, n_b, g, d_out,
                            d_in, stream);
    default:
      return launch_s<T, 7>(W, ws, wa, wc, x, xc, y, ya, n_b, g, d_out,
                            d_in, stream);
  }
}

}  // namespace

extern "C" {

// One brick group: W (S^dim, d_out, d_in, n_b, M) with (s, a, c) strides
// ws, wa, wc and contiguous (n_b, M) planes; x and y at the group's first
// slot, component strides xc and ya; the bordered grid (g0, g1, g2), with
// g0 = 1 in 2-D.  Writes every slot of the group's y.  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a shape it does not take.
int stencil_apply_f64(const void* W, long long ws, long long wa,
                      long long wc, const void* x, long long xc, void* y,
                      long long ya, int n_b, int dim, int g0, int g1, int g2,
                      int k, int d_out, int d_in, void* stream) {
  return launch<double>(W, ws, wa, wc, x, xc, y, ya, n_b, dim, g0, g1, g2,
                        k, d_out, d_in, stream);
}

int stencil_apply_f32(const void* W, long long ws, long long wa,
                      long long wc, const void* x, long long xc, void* y,
                      long long ya, int n_b, int dim, int g0, int g1, int g2,
                      int k, int d_out, int d_in, void* stream) {
  return launch<float>(W, ws, wa, wc, x, xc, y, ya, n_b, dim, g0, g1, g2, k,
                       d_out, d_in, stream);
}

}  // extern "C"
