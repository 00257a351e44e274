// serving_score: one random-effect coordinate's contribution to a serving
// flush, for NVIDIA Hopper (sm_90a).
//
//   out[i] = scale[s_i] * sum_d mat[i, d] * float(cache[s_i, d]),
//   s_i    = clamp(slots[i], 0, E - 1);  a null scale is a unit scale.
//
// Replaces the TPU kernel photon_ml_tpu/ops/kernels/serving_score.py
// score_rows_pallas (body _score_kernel, pl.pallas_call at :67), whose
// plain XLA chain is score_rows_xla. The Pallas design addresses the
// gathered cache row through scalar-prefetch BlockSpecs, one grid step per
// row; here the gather is a plain indexed load and the rows run in
// parallel, one warp each.
//
// Bound on the H100 (3.35 TB/s): the call must move n*d*4 bytes of
// features, the referenced cache rows (n*d*b_cache at most, b_cache = 1
// for int8 and 4 for f32), and 12*n bytes of slots, scales and outputs.
// Its 2*n*d flops are far below the card's f32 rate, so bytes bound it.
// At the serving shape (n <= 64, d = 8) that is under 5 KB: the kernel is
// bound by its launch. At the kernel-sweep shape (n = 4096, d = 512,
// E = 8192, int8) it is about 10.5 MB, a bound of about 3.1 us.
// No single PyTorch call computes gather + dot + scale, so there is no
// library yardstick for it.
//
// Design: one warp per row, 8 rows per 256-thread block. Each lane
// strides over d and accumulates in float32 in a fixed order; a
// __shfl_xor_sync butterfly then reduces across the warp, so every run
// gives the same bits. Lane 0 applies the row's scale and stores. The
// slot is clamped here, so no index from the caller can read outside the
// cache. No atomics, no shared memory, no allocation.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_rows_kernel(const float* __restrict__ mat,
                  const int32_t* __restrict__ slots,
                  const T* __restrict__ cache,
                  const float* __restrict__ scale,
                  float* __restrict__ out, int n, int d, int E) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together: row is per warp
  int s = slots[row];
  s = s < 0 ? 0 : (s >= E ? E - 1 : s);
  const float* x = mat + static_cast<size_t>(row) * d;
  const T* c = cache + static_cast<size_t>(s) * d;
  float acc = 0.0f;
  for (int k = lane; k < d; k += 32) {
    acc = fmaf(x[k], static_cast<float>(c[k]), acc);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) {
    out[row] = scale != nullptr ? acc * scale[s] : acc;
  }
}

template <typename T>
int launch(const void* mat, const void* slots, const void* cache,
           const void* scale, void* out, int n, int d, int E,
           void* stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  score_rows_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mat), static_cast<const int32_t*>(slots),
      static_cast<const T*>(cache), static_cast<const float*>(scale),
      static_cast<float*>(out), n, d, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int8 codes with a per-row float32 dequantisation scale (E,).
int serving_score_i8(const void* mat, const void* slots, const void* cache,
                     const void* scale, void* out, int n, int d, int E,
                     void* stream) {
  return launch<int8_t>(mat, slots, cache, scale, out, n, d, E, stream);
}

// float32 rows; scale may be null (a unit scale).
int serving_score_f32(const void* mat, const void* slots, const void* cache,
                      const void* scale, void* out, int n, int d, int E,
                      void* stream) {
  return launch<float>(mat, slots, cache, scale, out, n, d, E, stream);
}

}  // extern "C"
