// ell_scatter: the ELL scatter-add of the sparse GLM objective, for NVIDIA
// Hopper (sm_90a).
//
//   out[c] = sum over slots (i, k) with indices[i, k] == c of rv[i, k],
//            for 0 <= c < dim; padding slots (id >= dim) add nothing.
//
// It is the gradient, H.v and Hessian-diagonal reduction of the sparse
// (ELL) objective: rv = r[:, None] * values. Replaces the TPU kernel
// photon_ml_tpu/ops/kernels/ell_scatter.py scatter_rowterm_pallas
// (pl.pallas_call at :90, body _kernel at :34), whose plain XLA version is
// scatter_rowterm_xla. The Pallas program walks a (column tile x row tile)
// grid and, per cell, compares every slot id with 128 column ids: O(d*nnz)
// compares, cheap on the TPU's vector unit only while d stays near a few
// thousand. It is not carried over.
//
// Design. The ELL pattern is fixed for a whole fit, so the wrapper
// (photon_ml_torch/ops/kernels/ell_scatter.py build_layout) sorts the flat
// ids once per staged batch, stably, into a column-major permutation
// `perm` of the valid slots with a column pointer `col_ptr` (dim + 1).
// Every call is then a segmented sum in a fixed order, with no atomics:
//
//   pass 1 (piece_sums): columns of more than 32 entries are cut into
//     pieces of at most 4096 entries. One warp per piece: lane l adds
//     entries l, l + 32, l + 64, ... in order, then a __shfl_xor_sync
//     butterfly (16, 8, 4, 2, 1) adds the 32 lane sums; a commutative pair
//     per step, so every lane ends with the same bits. Lane 0 writes the
//     piece's partial.
//   pass 2 (column_sums): one thread per column. A column with pieces adds
//     its partials in order; a column of at most 32 entries adds them in
//     row order; an empty column writes 0.
//
// This answers the Zipf head of config 5 (d = 1,000,000, Zipf(1.3)
// columns): its hottest column holds an entry in nearly every row (about
// 10M at full size) while most columns hold 0-2. A thread per column alone
// would run a 10M-long chain of adds; here that column is ~2,400 warps of
// work in pass 1 and a 2,400-term sum in pass 2. Both passes are the same
// on every run, so two launches on the same inputs give the same bits.
//
// Bound on the H100 (3.35 TB/s): the function reads the (n, k) ids and row
// terms once (8 bytes a slot) and writes dim floats: at n = 9.5M, k = 32,
// dim = 1M about 2.44 GB, a bound of about 0.73 ms. Bytes bound it (one
// add per slot). This kernel reads perm sequentially (4 bytes a valid
// slot) but gathers rv[perm[j]] (a 32-byte sector for 4 useful bytes where
// a column's rows are far apart), so it moves more than the bound counts;
// forming r[row] * value in registers from column-sorted values would
// remove the gather and the (n, k) rv temporary, and is left for later.
//
// Offsets: perm entries, col_ptr and the piece bounds are int32 (the
// wrapper refuses more than 2^31 - 1 slots); loop counters are int64 and
// every pointer offset is formed in int64. No shared memory; the wrapper
// allocates out and the partials.
//
// Plain C interface for ctypes: the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
piece_sums_kernel(const float* __restrict__ rv,
                  const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ piece_start,
                  const int32_t* __restrict__ piece_end,
                  float* __restrict__ partial, int num_pieces) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (p >= num_pieces) return;  // the whole warp leaves together
  const int64_t hi = piece_end[p];
  float acc = 0.0f;
  for (int64_t j = static_cast<int64_t>(piece_start[p]) + lane; j < hi;
       j += 32) {
    acc += rv[static_cast<int64_t>(perm[j])];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) partial[p] = acc;
}

__global__ void __launch_bounds__(kThreads)
column_sums_kernel(const float* __restrict__ rv,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ col_ptr,
                   const int32_t* __restrict__ piece_ptr,
                   const float* __restrict__ partial,
                   float* __restrict__ out, int dim) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= dim) return;
  const int64_t p0 = piece_ptr[c];
  const int64_t p1 = piece_ptr[c + 1];
  float acc = 0.0f;
  if (p1 > p0) {
    for (int64_t p = p0; p < p1; ++p) acc += partial[p];
  } else {
    const int64_t hi = col_ptr[c + 1];
    for (int64_t j = col_ptr[c]; j < hi; ++j) {
      acc += rv[static_cast<int64_t>(perm[j])];
    }
  }
  out[c] = acc;
}

}  // namespace

extern "C" {

// out (dim,) = per-column sums of rv over the layout; rv is the flat
// (n * k,) row-term array, perm/col_ptr/piece_* the wrapper's layout, and
// partial a (max(num_pieces, 1),) scratch. All contiguous, on one device.
int ell_scatter(const void* rv, const void* perm, const void* col_ptr,
                const void* piece_ptr, const void* piece_start,
                const void* piece_end, void* partial, void* out, int dim,
                int num_pieces, void* stream) {
  if (dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rv);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  float* part = static_cast<float*>(partial);
  if (num_pieces > 0) {
    const int64_t blocks =
        (static_cast<int64_t>(num_pieces) + kWarpsPerBlock - 1) /
        kWarpsPerBlock;
    piece_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        r, pm, static_cast<const int32_t*>(piece_start),
        static_cast<const int32_t*>(piece_end), part, num_pieces);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (static_cast<int64_t>(dim) + kThreads - 1) /
                         kThreads;
  column_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      r, pm, static_cast<const int32_t*>(col_ptr),
      static_cast<const int32_t*>(piece_ptr), part,
      static_cast<float*>(out), dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
