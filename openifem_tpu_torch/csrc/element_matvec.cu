// Element-block matvec for Hopper (sm_90a): one kernel family for every
// layout of the matrix-free operators.
//
// Replaces openifem_tpu/la/pallas_ops.py::pallas_element_matvec (the
// Pallas kernel, which never lowered on Mosaic) and the XLA
// gather -> einsum -> scatter layouts of openifem_tpu/la/operators.py
// (element_matvec, _rect, _nodeblock, _u_to_p_nodeblock, _p_to_u_nodeblock
// and _taylor_hood).  Every one of them is the rectangular element matvec
//
//   y[rows[c, i / DR] * DR + i % DR] +=
//       sum_k A[c, i, k] * x[cols[c, k / DC] * DC + k % DC]
//
// with row and column component widths DR, DC in {1, d}.  A is read
// through a cell stride and a row stride (columns contiguous), so the
// Auu / Aup / Apu views of one coupled element matrix need no copies.
// The index tables are int32 and row-major (n_cells, nr / DR) and
// (n_cells, nc / DC).
//
// Design: owner computes.  Each local row (c, i) feeds exactly one output
// r, so the scatter inverts without recomputation: the gather plan of the
// row table (la/operators.py::make_gather_plan, the JAX package's
// transpose layout) lists, for each row entity e, the flat positions
// c * (nr / DR) + j of its K incidences, in increasing order, padded at
// the end with the sentinel n_cells * (nr / DR).  Output r = e * DR + a
// takes local row i = j * DR + a of each incidence.  A group of G lanes
// (G the largest power of two <= min(nc, 32); nc <= 256) owns one
// output: for each incidence in plan order the group reads the A row as
// one coalesced segment, each lane gathers its columns' x through the
// read-only path and accumulates, then a fixed xor-shuffle tree reduces
// the group and one lane writes y[r] with a plain store.  No atomics and
// no zero fill: the caller allocates y uninitialised, an output with no
// incidence gets 0, each apply is one launch, and y is bitwise the same
// from run to run.
// Neighbouring outputs (the d components of a node, the dofs of a cell)
// read neighbouring rows of the same cell, so a warp's loads stay close.
//
// Cost.  Every entry of A is used once: 2 flops per 8 B in f64, about
// 0.25 flop/B, so the bound is the bytes the function moves, A, the index
// tables, x and y each once, over 3.35 TB/s.  For the 1,780-cell leaflet
// in f64: u->p 1.25 MB (0.37 us), p->u 1.25 MB (0.37 us), node block
// 4.91 MB (1.47 us), Mp 0.29 MB (0.09 us), Taylor-Hood 7.31 MB (2.18 us).
// At these sizes one launch costs more than that bound, so one launch per
// apply and lanes that all have work are what the design buys.
//
// Latency.  A lane's work on one incidence is a chain of three dependent
// loads (plan entry -> column table -> x) before its FMA; the lane loads
// kUnroll plan entries at once and runs their chains side by side.
//
// Not used, and why: tensor cores (wgmma) -- a product with no reuse of A
// has nothing for them to do; TMA -- the rows are 72-176 B gathered row by
// row, and an f32 Taylor-Hood row is 88 B, not a multiple of 16 B, so bulk
// copies do not fit.  Coalesced row segments, busy lanes and one launch
// are the gains.

#include <cuda_runtime.h>

namespace {

// threads per block: small blocks spread small outputs over many SMs;
// measured on the H100, blocks of up to 512 or 1,024 threads for large
// outputs are slower at the Taylor-Hood shapes and no faster elsewhere
constexpr int kThreads = 64;
constexpr int kWarp = 32;
// incidences whose loads a lane issues together
constexpr int kUnroll = 4;
// columns a lane takes: G lanes share a block row of nc columns, with G
// the largest power of two <= min(nc, 32), so each lane takes
// S = ceil(nc / G) <= kMaxSteps of them (nc <= kMaxSteps * 32)
constexpr int kMaxSteps = 8;

// G lanes own one output; each takes the S columns lane, lane + G, ...
template <typename T, int G, int S>
__global__ void __launch_bounds__(kThreads) element_matvec_kernel(
    const T* __restrict__ A, long long cell_stride, long long row_stride,
    const int* __restrict__ cols, const int* __restrict__ plan,
    const T* __restrict__ x, T* __restrict__ y, int n_out, int K,
    int n_flat, int per_cell, int nc, int dr, int dc) {
  constexpr int kOutPerBlock = kThreads / G;
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * kOutPerBlock + threadIdx.x / G;
  // warp-uniform exit: every lane of a warp that stays reaches the
  // shuffles below
  const int warp_first =
      blockIdx.x * kOutPerBlock + (threadIdx.x / kWarp) * (kWarp / G);
  if (warp_first >= n_out) return;

  const bool active = r < n_out;
  const int e = active ? r / dr : 0;
  const int a = active ? r - e * dr : 0;
  // this lane's columns: entry q of the cell's column table, component
  // comp of it
  int q[S], comp[S];
  bool has[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int m = lane + s * G;
    has[s] = m < nc;
    q[s] = m / dc;
    comp[s] = m - q[s] * dc;
  }
  const int col_width = nc / dc;
  const int* pe = plan + (long long)e * K;

  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += kUnroll) {
    // kUnroll incidences at a time, straight-line, so that their loads
    // are in flight together
    int p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = (active && k0 + u < K) ? __ldg(pe + k0 + u) : n_flat;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p[u] < n_flat) {  // the sentinel pads the end of the row
        const int c = p[u] / per_cell;
        const int i = (p[u] - c * per_cell) * dr + a;
        const T* Ai =
            A + (long long)c * cell_stride + (long long)i * row_stride;
        const int* cc = cols + (long long)c * col_width;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (has[s]) {
            const T xv = __ldg(x + (long long)__ldg(cc + q[s]) * dc + comp[s]);
            acc = fma(__ldg(Ai + lane + s * G), xv, acc);
          }
        }
      }
    }
    if (p[kUnroll - 1] >= n_flat) break;  // the rest is padding
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (active && lane == 0) y[r] = acc;
}

template <typename T, int G, int S>
void launch_gs(const void* A, long long cell_stride, long long row_stride,
               const void* cols, const void* plan, const void* x, void* y,
               int n_out, int K, int n_flat, int per_cell, int nc, int dr,
               int dc, cudaStream_t stream) {
  constexpr int kOutPerBlock = kThreads / G;
  const int blocks = (n_out + kOutPerBlock - 1) / kOutPerBlock;
  element_matvec_kernel<T, G, S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(A), cell_stride, row_stride,
      static_cast<const int*>(cols), static_cast<const int*>(plan),
      static_cast<const T*>(x), static_cast<T*>(y), n_out, K, n_flat,
      per_cell, nc, dr, dc);
}

template <typename T>
int launch(const void* A, long long cell_stride, long long row_stride,
           const void* cols, const void* plan, const void* x, void* y,
           int n_out, int K, int n_flat, int nr, int nc, int dr, int dc,
           void* stream_ptr) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  if (nr <= 0 || nc <= 0 || dr <= 0 || dc <= 0 || nr % dr || nc % dc ||
      K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int per_cell = nr / dr;
  // G: the largest power of two <= min(nc, 32).  Measured on the H100
  // at the leaflet's shapes, half that (two or three columns a lane) and
  // twice that (every lane one column or none) are slower
  int G = 1;
  while (2 * G <= nc && 2 * G <= kWarp) G *= 2;
  const int S = (nc + G - 1) / G;
  if (S > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
#define OPENIFEM_EMV_S(G_)                                                 \
  switch (S) {                                                             \
    case 1: launch_gs<T, G_, 1>(OPENIFEM_EMV_ARGS); break;                 \
    case 2: launch_gs<T, G_, 2>(OPENIFEM_EMV_ARGS); break;                 \
    case 3: launch_gs<T, G_, 3>(OPENIFEM_EMV_ARGS); break;                 \
    case 4: launch_gs<T, G_, 4>(OPENIFEM_EMV_ARGS); break;                 \
    case 5: launch_gs<T, G_, 5>(OPENIFEM_EMV_ARGS); break;                 \
    case 6: launch_gs<T, G_, 6>(OPENIFEM_EMV_ARGS); break;                 \
    case 7: launch_gs<T, G_, 7>(OPENIFEM_EMV_ARGS); break;                 \
    default: launch_gs<T, G_, 8>(OPENIFEM_EMV_ARGS); break;                \
  }
#define OPENIFEM_EMV_ARGS                                                  \
  A, cell_stride, row_stride, cols, plan, x, y, n_out, K, n_flat,          \
      per_cell, nc, dr, dc, stream
  switch (G) {
    case 1: OPENIFEM_EMV_S(1); break;
    case 2: OPENIFEM_EMV_S(2); break;
    case 4: OPENIFEM_EMV_S(4); break;
    case 8: OPENIFEM_EMV_S(8); break;
    case 16: OPENIFEM_EMV_S(16); break;
    default: OPENIFEM_EMV_S(32); break;
  }
#undef OPENIFEM_EMV_ARGS
#undef OPENIFEM_EMV_S
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y[r], r < n_out, from the gather plan (n_out / dr, K) of the row table;
// y needs no initialisation.  Returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue for widths it does not take.
int element_matvec_f64(const void* A, long long cell_stride,
                       long long row_stride, const void* cols,
                       const void* plan, const void* x, void* y, int n_out,
                       int K, int n_flat, int nr, int nc, int dr, int dc,
                       void* stream) {
  return launch<double>(A, cell_stride, row_stride, cols, plan, x, y, n_out,
                        K, n_flat, nr, nc, dr, dc, stream);
}

int element_matvec_f32(const void* A, long long cell_stride,
                       long long row_stride, const void* cols,
                       const void* plan, const void* x, void* y, int n_out,
                       int K, int n_flat, int nr, int nc, int dr, int dc,
                       void* stream) {
  return launch<float>(A, cell_stride, row_stride, cols, plan, x, y, n_out,
                       K, n_flat, nr, nc, dr, dc, stream);
}

}  // extern "C"
