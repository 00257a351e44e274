// cold_grad: the cold-class gradient of the hybrid sparse layout, for NVIDIA
// Hopper (sm_90a).
//
//   out[c] = sum over l < L of r_pad[rows[c, l]] * vals[c, l],  c < C,
//   with r_pad[i] = r[i] for 0 <= i < n and 0 for any other id (the layout
//   pads with id n).
//
// One count class of the hybrid layout (photon_ml_torch/ops/hybrid_sparse.py)
// holds C columns of at most L entries each, padded to (C, L): per column
// the row ids of its entries and their values. Its gradient slice is the
// residual gathered at those rows, times the values, summed along L. The
// same function gives the H.v row term (r = w * d2l * (x . v)) and the
// Hessian diagonal (vals squared by the caller).
//
// Replaces the TPU kernel dev-scripts/exp_cold_gather.py fused_cold_grad
// (pl.pallas_call at :68, body _fused_kernel at :46): one pass that gathers
// r by row id and reduces along L, so the (C, L) gathered stream never
// reaches device memory. On the TPU it could not be lowered (Mosaic's gather
// takes only take-along-axis patterns), so the JAX package kept two XLA
// passes, a gather and then padded row sums (photon_ml_tpu/ops/
// hybrid_sparse.py _cold_grad). On Hopper the fused form is an ordinary
// kernel.
//
// Bound on the H100 (3.35 TB/s): the function reads the (C, L) ids and
// values once (8 bytes a slot), r once (4 n bytes) and writes C floats; one
// fused multiply-add a slot, so bytes bound it. The gather r[rows[c, l]] is
// random, but r is small (19 MB at n = 4.75M rows) and stays in the 50 MB
// L2 across a class; it is read through the read-only path (__ldg).
//
// Design. One owner per column, no atomics. A group of G lanes owns a
// column, G = min(32, the power of two at or above L): lane g adds entries
// g, g + G, g + 2G, ... of its column in order with a chain of fmaf, then
// the group adds its G lane sums by a __shfl_xor_sync butterfly (G/2, ...,
// 1); a commutative pair a step, so every lane of the group ends with the
// same bits. For L <= 32 each lane holds one entry and a warp covers 32 / G
// columns, whose entries lie side by side, so the warp's loads of ids and
// values are coalesced at every L; for L >= 64 a warp loops along its
// column. A row id outside [0, n) reads 0: the kernel bound-checks it
// rather than the caller copying r to n + 1 entries on every call. The
// order of every sum is fixed by (C, L), so two launches give the same bits.
//
// Offsets: C * L is formed in int64. The wrapper launches once per class and
// allocates out.
//
// Plain C interface for ctypes: the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
cold_grad_kernel(const float* __restrict__ r, const int32_t* __restrict__ rows,
                 const float* __restrict__ vals, float* __restrict__ out,
                 int64_t C, int L, int n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t col = t / G;
  const int g = static_cast<int>(t % G);
  float acc = 0.0f;
  if (col < C) {
    const int64_t base = col * static_cast<int64_t>(L);
    for (int l = g; l < L; l += G) {
      const int32_t id = rows[base + l];
      const float x = static_cast<uint32_t>(id) < static_cast<uint32_t>(n)
                          ? __ldg(r + id)
                          : 0.0f;
      acc = fmaf(x, vals[base + l], acc);
    }
  }
  // Every lane of the warp takes part (columns past C add zeros), so the
  // full-mask shuffles are legal; offsets below G stay inside the group.
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (g == 0 && col < C) out[col] = acc;
}

template <int G>
int launch(const float* r, const int32_t* rows, const float* vals, float* out,
           int64_t C, int L, int n, cudaStream_t s) {
  const int64_t blocks = (C * G + kThreads - 1) / kThreads;
  cold_grad_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      r, rows, vals, out, C, L, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (C,) = per-column sums of r_pad[rows] * vals over one (C, L) class.
// r (n,) float32, rows (C, L) int32, vals (C, L) float32, all contiguous on
// one device.
int cold_grad(const void* r, const void* rows, const void* vals, void* out,
              long long C, int L, int n, void* stream) {
  if (C <= 0) return 0;
  if (L < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* rr = static_cast<const float*>(r);
  const int32_t* ids = static_cast<const int32_t*>(rows);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 1) return launch<1>(rr, ids, v, o, C, L, n, s);
  if (L <= 2) return launch<2>(rr, ids, v, o, C, L, n, s);
  if (L <= 4) return launch<4>(rr, ids, v, o, C, L, n, s);
  if (L <= 8) return launch<8>(rr, ids, v, o, C, L, n, s);
  if (L <= 16) return launch<16>(rr, ids, v, o, C, L, n, s);
  return launch<32>(rr, ids, v, o, C, L, n, s);
}

}  // extern "C"
