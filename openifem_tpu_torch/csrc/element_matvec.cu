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
// Cost.  The kernel is bound by reading A: the Taylor-Hood f64 apply of
// the fsi_leaflet case reads 1780 * 22 * 22 * 8 B = 6.9 MB of A against
// about 0.15 MB of x and y.  At this size one apply is a few microseconds
// of DRAM traffic on an H100, so in practice it is bound by launch and
// latency more than by bandwidth; one launch per apply (instead of the
// gather, batched product and scatter of the plain version) is what this
// design buys.
//
// Design: one warp per cell.  The warp stages the gathered x of its cell
// in shared memory, each lane owns one local row and forms its dot
// product, and the row result is scattered with atomicAdd (native for
// double on sm_90).  y must be zero-filled by the caller.
//
// Atomics reorder the sum over the cells that share a dof, so results
// vary in the last bits from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWarp = 32;

template <typename T>
__global__ void element_matvec_kernel(
    const T* __restrict__ A, long long cell_stride, long long row_stride,
    const int* __restrict__ rows, const int* __restrict__ cols,
    const T* __restrict__ x, T* __restrict__ y, int n_cells, int nr,
    int nc, int dr, int dc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int cell = blockIdx.x * kWarpsPerBlock + warp;
  if (cell >= n_cells) return;  // warp-uniform: the whole warp leaves

  // gather this cell's x into shared memory
  T* xl = xs + warp * nc;
  const int* ccols = cols + (long long)cell * (nc / dc);
  for (int k = lane; k < nc; k += kWarp) {
    xl[k] = x[(long long)ccols[k / dc] * dc + k % dc];
  }
  __syncwarp();

  // one lane per local row: dot product, then scatter-add
  const T* Ac = A + (long long)cell * cell_stride;
  const int* crows = rows + (long long)cell * (nr / dr);
  for (int i = lane; i < nr; i += kWarp) {
    const T* Ai = Ac + (long long)i * row_stride;
    T acc = T(0);
    for (int k = 0; k < nc; ++k) {
      acc += Ai[k] * xl[k];
    }
    atomicAdd(y + (long long)crows[i / dr] * dr + i % dr, acc);
  }
}

template <typename T>
int launch(const void* A, long long cell_stride, long long row_stride,
           const void* rows, const void* cols, const void* x, void* y,
           int n_cells, int nr, int nc, int dr, int dc, void* stream) {
  if (n_cells > 0 && nr > 0 && nc > 0) {
    const int blocks = (n_cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = (size_t)kWarpsPerBlock * nc * sizeof(T);
    element_matvec_kernel<T>
        <<<blocks, kWarpsPerBlock * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(A), cell_stride, row_stride,
            static_cast<const int*>(rows), static_cast<const int*>(cols),
            static_cast<const T*>(x), static_cast<T*>(y), n_cells, nr, nc,
            dr, dc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int element_matvec_f64(const void* A, long long cell_stride,
                       long long row_stride, const void* rows,
                       const void* cols, const void* x, void* y,
                       int n_cells, int nr, int nc, int dr, int dc,
                       void* stream) {
  return launch<double>(A, cell_stride, row_stride, rows, cols, x, y,
                        n_cells, nr, nc, dr, dc, stream);
}

int element_matvec_f32(const void* A, long long cell_stride,
                       long long row_stride, const void* rows,
                       const void* cols, const void* x, void* y,
                       int n_cells, int nr, int nc, int dr, int dc,
                       void* stream) {
  return launch<float>(A, cell_stride, row_stride, rows, cols, x, y,
                       n_cells, nr, nc, dr, dc, stream);
}

}  // extern "C"
