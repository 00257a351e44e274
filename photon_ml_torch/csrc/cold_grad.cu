// cold_grad: the cold-class gradient of the hybrid sparse layout, for NVIDIA
// Hopper (sm_90a), every class of a pass in one launch.
//
//   out[o_k + c] = sum over l < L_k of r_pad[rows_k[c, l]] * vals_k[c, l],
//   c < C_k, for every class k, with r_pad[i] = r[i] for 0 <= i < n and 0
//   for any other id (the layout pads with id n).
//
// The hybrid layout (photon_ml_torch/ops/hybrid_sparse.py) holds its cold
// columns in count classes: class k is C_k columns of at most L_k entries
// each, padded to (C_k, L_k), per column the row ids of its entries and
// their values. Every class's ids and values lie in two flat arrays, class
// after class (row-major inside a class); o_k is the class's first output.
// A class's gradient slice is the residual gathered at those rows, times
// the values, summed along L. The same function gives the H.v row term
// (r = w * d2l * (x . v)) and the Hessian diagonal (vals squared by the
// caller).
//
// Replaces the TPU kernel dev-scripts/exp_cold_gather.py fused_cold_grad
// (pl.pallas_call at :68, body _fused_kernel at :46): one pass that gathers
// r by row id and reduces along L, so the (C, L) gathered stream never
// reaches device memory. On the TPU it could not be lowered (Mosaic's gather
// takes only take-along-axis patterns), so the JAX package kept two XLA
// passes, a gather and then padded row sums (photon_ml_tpu/ops/
// hybrid_sparse.py _cold_grad).
//
// Bound on the H100 (3.35 TB/s): bytes. The function reads the ids and
// values once (8 bytes a slot), each r it needs once and writes one float a
// column; one fused multiply-add a slot. At the config-5 main shape (4.75M
// rows, 13 classes from (181, 4096) to (239861, 1), 768,259 columns,
// 16,265,517 slots, 11.6M of them live) that is 151 MB, 0.045 ms. The
// gather r[rows[c, l]] is random: r (19 MB) stays in the 50 MB L2 and is
// read through the read-only path (__ldg), and the ids and values, read
// once, stream through with the evict-first hint (__ldcs), so they do not
// push r out. What the kernel meets first on the H100 is not the bytes but
// the rate of those random 4-byte reads from L2: chip_smoke.py times one
// r.index_select at the 11.6M live ids, the gathers alone, at about 0.115
// ms, and this kernel's whole pass at about 0.106 ms (NVIDIA H100 80GB
// HBM3, 700 W).
//
// What held the first design back (one launch per class, a group of
// min(32, L) lanes per column, scalar loads, one dependent gather per loop
// step), timed by chip_smoke.py class by class on the same card: 0.173 ms
// a pass, 26% of the bound; every class at 26-36% of its own bound, and the
// 181 columns of L = 4,096 at 12% (18.7 us for 2.2): one warp a column
// walking 128 steps of load, then gather, then add, 181 warps on 132 SMs.
// The 13 launches ran one after another, each with its own ramp and tail
// (4.4-6.6 us for each class of L <= 4).
//
// This design:
// - One launch over every class. A table of at most kMaxClasses entries,
//   passed by value (__grid_constant__, so it lives in the constant bank),
//   gives each class its first slot, C, L, threads per column T, first
//   output and first block. A block finds its class by a scan of the
//   table's block starts; every thread of a block serves one class.
// - Threads per column grow with L (the wrapper's policy: T = the power of
//   two that leaves each thread about 4 slots, at most a block of 256):
//   short columns share a warp in groups of T lanes, long ones get up to a
//   whole block. Column c's slots are cut into chunks of 4 (2 or 1 where L
//   is not a multiple); lane j of the column's T takes chunks j, j + T,
//   j + 2T, ..., so the lanes of a warp read neighbouring 16-byte vectors
//   (int4 / float4 where the class's rows start on 16 bytes in both
//   arrays, scalar loads otherwise). A lane loads up to four chunks' ids
//   and values, then issues their gathers, then adds: every gather of a
//   chunk in flight at once instead of one, and enough threads (one a
//   chunk below L = 2,048) to keep the L2 busy with them.
// - One owner per column, no atomics. Each lane adds its chunks in order
//   with a chain of fmaf (slot order inside a chunk); the lanes of a warp
//   add by a __shfl_xor_sync butterfly (a commutative pair a step, so every
//   lane ends with the same bits); for T > 32 the warp sums of a column
//   are added in warp order through shared memory. The order of every sum
//   is fixed by L alone (T and the chunk width follow from it; the load
//   width does not change it), so two launches give the same bits.
// - A row id outside [0, n) reads 0: the kernel bound-checks it rather
//   than the caller copying r to n + 1 entries on every call.
//
// Offsets are int64. Plain C interface for ctypes: the launcher returns a
// cudaError_t (cudaErrorInvalidValue for a table it refuses).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 32;
// Fields of one class in the launcher's table, in this order.
constexpr int kFields = 6;

struct ClassEntry {
  int64_t offset;   // first slot of the class in rows and vals
  int64_t columns;  // C
  int64_t out0;     // first output of the class
  int64_t block0;   // first block of the class
  int32_t length;   // L
  int32_t threads;  // T: a power of two, at most kThreads
  int32_t chunk;    // slots a lane takes at once: 4, 2 or 1, dividing L
  int32_t vec;      // load width: chunk, or 1 where the rows are not aligned
};

struct Table {
  ClassEntry e[kMaxClasses];
  int32_t count;
  int32_t n;
};

template <int CHUNK, int VEC>
__device__ __forceinline__ void load_chunk(const int32_t* ids, const float* v,
                                           int32_t (&id)[CHUNK],
                                           float (&x)[CHUNK]) {
  if constexpr (VEC == 4) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(ids));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(v));
    id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
    x[0] = b.x; x[1] = b.y; x[2] = b.z; x[3] = b.w;
  } else if constexpr (VEC == 2) {
    const int2 a = __ldcs(reinterpret_cast<const int2*>(ids));
    const float2 b = __ldcs(reinterpret_cast<const float2*>(v));
    id[0] = a.x; id[1] = a.y;
    x[0] = b.x; x[1] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      id[c] = __ldcs(ids + c);
      x[c] = __ldcs(v + c);
    }
  }
}

// U chunks of one column, starting at chunk q, T chunks apart: every load
// first, then every gather, then the adds in chunk and slot order.
template <int U, int CHUNK, int VEC>
__device__ __forceinline__ float add_chunks(const float* __restrict__ r,
                                            const int32_t* __restrict__ ids,
                                            const float* __restrict__ v,
                                            int n, int q, int T, float acc) {
  int32_t id[U][CHUNK];
  float x[U][CHUNK];
  float g[U][CHUNK];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t at = static_cast<int64_t>(q + u * T) * CHUNK;
    load_chunk<CHUNK, VEC>(ids + at, v + at, id[u], x[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      g[u][c] = static_cast<uint32_t>(id[u][c]) < static_cast<uint32_t>(n)
                    ? __ldg(r + id[u][c])
                    : 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) acc = fmaf(g[u][c], x[u][c], acc);
  }
  return acc;
}

// Lane `lane` of a column's T: the in-order sum of chunks lane, lane + T, ...
template <int CHUNK, int VEC>
__device__ float lane_sum(const float* __restrict__ r,
                          const int32_t* __restrict__ ids,
                          const float* __restrict__ v, int n, int chunks,
                          int lane, int T) {
  float acc = 0.0f;
  int q = lane;
  for (; q + 3 * T < chunks; q += 4 * T) {
    acc = add_chunks<4, CHUNK, VEC>(r, ids, v, n, q, T, acc);
  }
  if (q + T < chunks) {
    acc = add_chunks<2, CHUNK, VEC>(r, ids, v, n, q, T, acc);
    q += 2 * T;
  }
  if (q < chunks) acc = add_chunks<1, CHUNK, VEC>(r, ids, v, n, q, T, acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
cold_grad_kernel(const float* __restrict__ r, const int32_t* __restrict__ rows,
                 const float* __restrict__ vals, float* __restrict__ out,
                 const __grid_constant__ Table t) {
  __shared__ float warp_sums[kWarps];
  const int64_t b = blockIdx.x;
  int k = 0;
  while (k + 1 < t.count && b >= t.e[k + 1].block0) ++k;
  const ClassEntry& e = t.e[k];
  const int T = e.threads;
  const int tid = threadIdx.x;
  const int lane = tid & (T - 1);
  const int64_t col = (b - e.block0) * (kThreads / T) + tid / T;
  const bool live = col < e.columns;
  float acc = 0.0f;
  if (live) {
    const int64_t base = e.offset + col * static_cast<int64_t>(e.length);
    const int32_t* ids = rows + base;
    const float* v = vals + base;
    const int chunks = e.length / e.chunk;
    switch (e.chunk * 8 + e.vec) {
      case 4 * 8 + 4:
        acc = lane_sum<4, 4>(r, ids, v, t.n, chunks, lane, T);
        break;
      case 4 * 8 + 1:
        acc = lane_sum<4, 1>(r, ids, v, t.n, chunks, lane, T);
        break;
      case 2 * 8 + 2:
        acc = lane_sum<2, 2>(r, ids, v, t.n, chunks, lane, T);
        break;
      case 2 * 8 + 1:
        acc = lane_sum<2, 1>(r, ids, v, t.n, chunks, lane, T);
        break;
      default:
        acc = lane_sum<1, 1>(r, ids, v, t.n, chunks, lane, T);
        break;
    }
  }
  // Every lane of the block takes part (columns past C add zeros), so the
  // full-mask shuffles are legal; T is the same for the whole block.
  if (T <= 32) {
    for (int offset = T >> 1; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, offset);
    }
    if (live && lane == 0) out[e.out0 + col] = acc;
    return;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if ((tid & 31) == 0) warp_sums[tid >> 5] = acc;
  __syncthreads();
  if (live && lane == 0) {
    const int w0 = tid >> 5;
    float s = warp_sums[w0];
    for (int w = 1; w < (T >> 5); ++w) s += warp_sums[w0 + w];
    out[e.out0 + col] = s;
  }
}

bool aligned(const void* p, int64_t offset, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) + static_cast<uintptr_t>(offset) * 4)
             % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

extern "C" {

// out = every class's column sums, class after class. r (n,) float32, rows
// int32 and vals float32 flat, out float32 (sum of C), all contiguous on one
// device. table: count rows of kFields int64 (first slot, C, L, threads per
// column, first output, first block), blocks the launch's block count.
int cold_grad_classes(const void* r, const void* rows, const void* vals,
                      void* out, int count, const long long* table,
                      long long blocks, int n, void* stream) {
  if (count < 0 || count > kMaxClasses || n < 0 || blocks < 0
      || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0 || blocks == 0) return 0;
  Table t = {};
  t.count = count;
  t.n = n;
  for (int k = 0; k < count; ++k) {
    const long long* f = table + static_cast<int64_t>(k) * kFields;
    ClassEntry& e = t.e[k];
    e.offset = f[0];
    e.columns = f[1];
    e.out0 = f[4];
    e.block0 = f[5];
    const long long L = f[2], T = f[3];
    if (e.offset < 0 || e.columns < 0 || L < 0 || L > 0x7fffffffLL || T < 1
        || T > kThreads || (T & (T - 1)) != 0 || e.out0 < 0 || e.block0 < 0
        || e.block0 > blocks || (k > 0 && e.block0 < t.e[k - 1].block0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    e.length = static_cast<int32_t>(L);
    e.threads = static_cast<int32_t>(T);
    e.chunk = L > 0 && L % 4 == 0 ? 4 : (L > 0 && L % 2 == 0 ? 2 : 1);
    e.vec = e.chunk > 1 && aligned(rows, e.offset, 4 * e.chunk)
                    && aligned(vals, e.offset, 4 * e.chunk)
                ? e.chunk
                : 1;
  }
  cold_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const int32_t*>(rows),
      static_cast<const float*>(vals), static_cast<float*>(out), t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
