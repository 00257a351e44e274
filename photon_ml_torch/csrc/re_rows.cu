// re_rows: the two row moves of a random-effect bucket wave, for NVIDIA
// Hopper (sm_90a).
//
//   gather:  out[b, :] = W[max(rows[b], 0), :]          (warm starts)
//   scatter: W[rows[b], :] = vals[b, :]  for rows[b] >= 0, in place
//
// over the (E, d) float32 coefficient table. Replaces the TPU kernels
// photon_ml_tpu/ops/kernels/re_rows.py gather_rows_pallas (pl.pallas_call
// at :70) and scatter_rows_pallas (:111), whose plain XLA versions are
// gather_rows_xla and scatter_rows_xla. The Pallas programs address the
// table through scalar-prefetch BlockSpecs, one grid step per lane row,
// and the scatter redirects padding lanes (-1) at a valid row because a
// block schedule must write on every step. Here the rows run in parallel
// and a padding lane of the scatter simply writes nothing.
//
// Bound on the H100 (3.35 TB/s): pure data movement, no arithmetic. The
// gather reads B*d*4 bytes of rows and B*4 of ids and writes B*d*4; the
// scatter reads and writes V*d*4 (V valid lanes) and reads B*4 of ids. A
// full config-4 wave (B = 65,536, d = 8) moves about 4.5 MB: a bound of
// about 1.3 us. Bytes bound it.
//
// Design: one thread per 16-byte vector of a row when d % 4 == 0 and
// every pointer is 16-byte aligned (one thread per float otherwise), in
// a grid-stride loop over the flattened (B, d) lanes. Neighbouring
// threads touch neighbouring addresses of one row and rows follow one
// another, so at d = 8 a warp moves 16 whole rows and at d = 512 a row
// spans four warps: every access is coalesced at any d. A row id is read
// once per vector from L1. Within one wave the row ids of valid lanes are
// unique (each entity lives in one bucket lane), so the scatter's writes
// never collide and need no atomics: the result is bit-exact and the same
// on every run. Ids are not range-checked here; the wrapper checks them.
// No shared memory, no allocation.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 blocks per SM, then stride

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ W, const int32_t* __restrict__ rows,
                   V* __restrict__ out, int64_t total, int dv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t b = t / dv;
    const int64_t k = t - b * dv;
    const int32_t r = rows[b];
    out[t] = W[static_cast<int64_t>(r < 0 ? 0 : r) * dv + k];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(V* __restrict__ W, const int32_t* __restrict__ rows,
                    const V* __restrict__ vals, int64_t total, int dv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t b = t / dv;
    const int32_t r = rows[b];
    if (r >= 0) {
      W[static_cast<int64_t>(r) * dv + (t - b * dv)] = vals[t];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

dim3 grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(blocks < kMaxBlocks ? blocks
                                                        : kMaxBlocks));
}

}  // namespace

extern "C" {

// out (B, d) = W[max(rows, 0)]; W (E, d), rows (B,) int32, all contiguous.
int re_gather_rows(const void* W, const void* rows, void* out, int B, int d,
                   void* stream) {
  if (B <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  if (d % 4 == 0 && aligned16(W) && aligned16(out)) {
    const int dv = d / 4;
    const int64_t total = static_cast<int64_t>(B) * dv;
    gather_rows_kernel<float4><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float4*>(W), r, static_cast<float4*>(out), total,
        dv);
  } else {
    const int64_t total = static_cast<int64_t>(B) * d;
    gather_rows_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(W), r, static_cast<float*>(out), total, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// W[rows[b]] = vals[b] for rows[b] >= 0, in place; W (E, d), rows (B,)
// int32, vals (B, d), all contiguous; valid row ids unique.
int re_scatter_rows(void* W, const void* rows, const void* vals, int B,
                    int d, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  if (d % 4 == 0 && aligned16(W) && aligned16(vals)) {
    const int dv = d / 4;
    const int64_t total = static_cast<int64_t>(B) * dv;
    scatter_rows_kernel<float4><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<float4*>(W), r, static_cast<const float4*>(vals), total,
        dv);
  } else {
    const int64_t total = static_cast<int64_t>(B) * d;
    scatter_rows_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<float*>(W), r, static_cast<const float*>(vals), total,
        d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
