// hot_pass: one read of the hybrid layout's hot block per objective
// evaluation, for NVIDIA Hopper (sm_90a). The block is float32
// (hot_pass_f32) or bfloat16 (hot_pass_bf16).
//
// Value and gradient (hessian = false):
//   z[i]  = (sum_h X[i, h] * w[h] + offsets[i]) + cold_z[i]
//   r[i]  = weights[i] > 0 ? weights[i] * dl(z[i], y[i]) : 0
//   g[h]  = sum_i X[i, h] * rho(r[i])
// H.v (hessian = true), besides z:
//   xv[i] = ((sum_h X[i, h] * v[h] + offsets[i]) + cold_zv[i]) - offsets[i]
//   r[i]  = (weights[i] > 0 ? weights[i] * d2(z[i], y[i]) : 0) * xv[i]
// cold_z and cold_zv may be null (no cold classes): the term is left out.
// rho is the identity over a float32 block; over a bfloat16 block it rounds
// r[i] to bfloat16 (to nearest even), as the reference's unfused route
// rounds r before X^T r (photon_ml_tpu/ops/hybrid_sparse.py _hot_rmatvec).
// w and v arrive float32, already rounded to bfloat16 by the caller over a
// bfloat16 block (_hot_matvec rounds them). Every product x * w and
// x * rho(r) of a bfloat16 block is then exact in float32, and the sums
// run in float32.
//
// Replaces, as they run on the hybrid block, the TPU kernels
// photon_ml_tpu/ops/kernels/stream_fused.py hot_margins_pallas
// (pl.pallas_call at :77) and hot_rmatvec_pallas (:123), which the port
// runs as two kernels (csrc/stream_fused.cu). Row i's residual depends only
// on row i's margin, so one pass that holds a tile of rows on chip can form
// each row's dot product, then r[i], then the tile's share of X^T r before
// it drops the tile: the (n, H) block is read once an evaluation instead of
// twice (three times for H.v: X w, X v, X^T r).
//
// Bound on the H100 (3.35 TB/s): bytes. At the config-5 hybrid shape
// (n = 4,750,000, H = 1,772, float32) X is 33.67 GB; offsets, cold_z,
// labels and weights read and z written add 95 MB: 10.08 ms. Its 4 n H
// flops take 0.50 ms at the 67 TFLOP/s float32 rate outside the tensor
// cores. A bfloat16 block moves half the bytes a column for the same
// flops (plus one conversion an element), so bytes still bound it: at
// config 5's 9.5M rows (threshold n/4096, about 3,000 columns) about
// 57 GB, 17 ms.
//
// Design.
// - A persistent grid (at most the blocks the card holds at once) walks
//   fixed groups of kGroup = 512 rows: block b takes groups b, b + P, ...
//   Each group gives one partial row of g, written to partial[group, :];
//   a second launch adds the partials in group order. No atomics: every
//   sum's order is fixed by n and H alone, not by the grid or by
//   scheduling, so two launches give the same bits.
// - A ring of S tiles of R rows in dynamic shared memory (the wrapper picks
//   R <= 8 and S >= 2 with S * R * H * sizeof(element) bytes plus float32 w
//   (and v) under the 227 KB a block may hold: R = 8, S = 3 at H = 1,772
//   float32). Thread 0 fills a tile with one bulk copy a row
//   (cp.async.bulk; rows are a multiple of 16 bytes: H a multiple of 4
//   float32 or 8 bfloat16 columns) completing on the slot's mbarrier, and
//   refills a slot as soon as the block has consumed it, so S - 1 tiles
//   are in flight while one is used. A block's ring runs on from one group
//   to the next. At H = 2,984 bfloat16 (config 5's 9.5M rows): R = 8,
//   S = 4.
// - (a) Margins: warp q takes row q of the tile, out of shared memory, in
//   exactly hot_margins_kernel's order (csrc/stream_fused.cu): lane l
//   owns the 16-byte vectors l, l + 32, ... of the row (4 float32 or 8
//   bfloat16 elements each, a bfloat16 widened to float32 in registers)
//   and adds their products with fmaf in element order, the xor butterfly
//   16 .. 1 adds the lane sums, then + offsets[i], then + cold_z[i]. So z
//   equals the two-kernel route's hot_margins + scatter bit for bit, for
//   either element type. Each row's offsets, labels, weights and cold
//   terms are loaded before the wait on the tile, so their latency hides
//   behind it.
// - (b) The residual, from the loss's device policy: the formulas of
//   photon_ml_torch/ops/losses.py, with each product that feeds an add
//   rounded on its own (__fmul_rn), so no contraction changes the bits.
//   Over a bfloat16 block it is then rounded to bfloat16 (rho).
// - (c) The transposed product: thread t owns the 16-byte column vectors
//   t, t + 256, ... (at most 8 of 4 float32 columns or 4 of 8 bfloat16
//   ones, H <= 8,192) as float32 sums in registers and adds x * rho(r[i])
//   with fmaf, tile row after tile row.
//
// HOT_PASS_TIMING_NO_TRANSPOSE, defined only by chip_smoke.py's timing
// harness in its own build, leaves phase (c) out, to show what the
// transposed product costs inside the pass. The package never defines it.
//
// Offsets are int64. Plain C interface for ctypes: the launcher returns a
// cudaError_t (cudaErrorInvalidValue for a shape or geometry it refuses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 512;     // rows a partial row covers
constexpr int kMaxRows = 8;     // tile rows: one warp a row in phase (a)
constexpr int kMaxStages = 8;
constexpr int kMaxVec = 8;      // float4 column vectors a thread owns
constexpr int kMaxColumns = 4 * kThreads * kMaxVec;
constexpr int kMaxShared = 232448;  // opt-in shared memory of a block
constexpr int kSumWarps = 32;

struct Logistic {
  __device__ static float dl(float z, float y) {
    return 1.0f / (1.0f + expf(-z)) - y;
  }
  __device__ static float d2(float z, float) {
    const float s = 1.0f / (1.0f + expf(-z));
    return s * (1.0f - s);
  }
};

struct Squared {
  __device__ static float dl(float z, float y) { return z - y; }
  __device__ static float d2(float, float) { return 1.0f; }
};

struct Poisson {
  __device__ static float dl(float z, float y) { return expf(z) - y; }
  __device__ static float d2(float z, float) { return expf(z); }
};

// Labels in {0, 1} map to y in {-1, +1}; t = y z.
struct SmoothedHinge {
  __device__ static float t_of(float z, float label, float* y) {
    *y = __fsub_rn(__fmul_rn(2.0f, label), 1.0f);
    return __fmul_rn(*y, z);
  }
  __device__ static float dl(float z, float label) {
    float y;
    const float t = t_of(z, label, &y);
    const float g = t <= 0.0f ? -1.0f : (t < 1.0f ? t - 1.0f : 0.0f);
    return y * g;
  }
  __device__ static float d2(float z, float label) {
    float y;
    const float t = t_of(z, label, &y);
    return (t > 0.0f && t < 1.0f) ? 1.0f : 0.0f;
  }
};

struct Args {
  const float* X;
  const float* w;
  const float* v;  // null for value and gradient
  const float* offsets;
  const float* cold_z;   // may be null
  const float* cold_zv;  // may be null
  const float* labels;
  const float* weights;
  float* z;
  float* xv;
  float* partial;  // (groups, H)
  int64_t n;
  int64_t groups;
  int H;
  int rows;    // R
  int stages;  // S
};

// The ring's rows hold ``itemsize``-byte elements (4: float32, 2:
// bfloat16); w and v are float32 either way.
__host__ __device__ constexpr size_t shared_bytes(int H, int R, int S,
                                                  bool hessian,
                                                  int itemsize = 4) {
  return static_cast<size_t>(S) * R * H * itemsize +
         (hessian ? 2 : 1) * H * 4 + kMaxRows * 4 + S * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy global -> shared, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float dot4(float4 x, float4 w, float a) {
  a = fmaf(x.x, w.x, a);
  a = fmaf(x.y, w.y, a);
  a = fmaf(x.z, w.z, a);
  return fmaf(x.w, w.w, a);
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, offset);
  }
  return a;
}

template <class Loss, bool kHessian>
__global__ void __launch_bounds__(kThreads, 1) hot_pass_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, R = a.rows, S = a.stages;
  const int nvec = H / 4;
  float4* tiles = reinterpret_cast<float4*>(smem);
  float4* w_s = tiles + static_cast<size_t>(S) * R * nvec;
  float4* v_s = w_s + nvec;
  float* r_s = reinterpret_cast<float*>(w_s + (kHessian ? 2 : 1) * nvec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(r_s + kMaxRows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t P = gridDim.x;

  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4* v4 = reinterpret_cast<const float4*>(a.v);
  for (int j = tid; j < nvec; j += kThreads) {
    w_s[j] = w4[j];
    if (kHessian) v_s[j] = v4[j];
  }
  // This block's tiles: groups b, b + P, ..., kGroup / R tiles each; only
  // the last group of all may be short.
  const int per_group = kGroup / R;
  const int64_t my_groups = (a.groups - b + P - 1) / P;
  const int64_t last_row0 = (b + (my_groups - 1) * P) * kGroup;
  const int64_t last_rows =
      a.n - last_row0 < kGroup ? a.n - last_row0 : kGroup;
  const int64_t my_tiles = (my_groups - 1) * per_group + (last_rows + R - 1) / R;
  auto tile_row0 = [&](int64_t t) {
    const int64_t k = t / per_group;
    return (b + k * P) * kGroup + (t - k * per_group) * R;
  };
  auto tile_rows = [&](int64_t row0) {
    return static_cast<int>(a.n - row0 < R ? a.n - row0 : R);
  };
  const uint32_t row_bytes = static_cast<uint32_t>(H) * 4;
  auto issue = [&](int64_t t) {
    const int slot = static_cast<int>(t % S);
    const int64_t row0 = tile_row0(t);
    const int rows = tile_rows(row0);
    mbar_expect_tx(&bars[slot], rows * row_bytes);
    for (int q = 0; q < rows; ++q) {
      bulk_load(tiles + (static_cast<size_t>(slot) * R + q) * nvec,
                a.X + (row0 + q) * static_cast<int64_t>(H), row_bytes,
                &bars[slot]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int64_t t = 0; t < S && t < my_tiles; ++t) issue(t);
  }

  float4 acc[kMaxVec];
#pragma unroll
  for (int m = 0; m < kMaxVec; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int64_t t = 0; t < my_tiles; ++t) {
    const int slot = static_cast<int>(t % S);
    const int64_t row0 = tile_row0(t);
    const int rows = tile_rows(row0);
    const int64_t i = row0 + warp;
    const bool mine = warp < rows;
    float off = 0.f, cz = 0.f, czv = 0.f, y = 0.f, wt = 0.f;
    if (mine) {
      off = a.offsets[i];
      y = a.labels[i];
      wt = a.weights[i];
      if (a.cold_z) cz = a.cold_z[i];
      if (kHessian && a.cold_zv) czv = a.cold_zv[i];
    }
    mbar_wait(&bars[slot], static_cast<uint32_t>((t / S) & 1));
    const float4* tile = tiles + static_cast<size_t>(slot) * R * nvec;

    // (a) margins and (b) the residual: one warp a row.
    if (mine) {
      const float4* x = tile + static_cast<size_t>(warp) * nvec;
      float s = 0.f, sv = 0.f;
      for (int j = lane; j < nvec; j += 32) {
        const float4 xj = x[j];
        s = dot4(xj, w_s[j], s);
        if (kHessian) sv = dot4(xj, v_s[j], sv);
      }
      s = warp_sum(s);
      float zi = s + off;
      if (a.cold_z) zi = zi + cz;
      float ri;
      if (kHessian) {
        sv = warp_sum(sv);
        float xvi = sv + off;
        if (a.cold_zv) xvi = xvi + czv;
        xvi = xvi - off;
        ri = (wt > 0.f ? wt * Loss::d2(zi, y) : 0.f) * xvi;
        if (lane == 0) a.xv[i] = xvi;
      } else {
        ri = wt > 0.f ? wt * Loss::dl(zi, y) : 0.f;
      }
      if (lane == 0) {
        a.z[i] = zi;
        r_s[warp] = ri;
      }
    }
    __syncthreads();

#ifndef HOT_PASS_TIMING_NO_TRANSPOSE
    // (c) this tile's share of X^T r, row after row.
    for (int q = 0; q < rows; ++q) {
      const float rq = r_s[q];
      const float4* x = tile + static_cast<size_t>(q) * nvec;
#pragma unroll
      for (int m = 0; m < kMaxVec; ++m) {
        const int j = tid + m * kThreads;
        if (j < nvec) {
          const float4 xj = x[j];
          acc[m].x = fmaf(xj.x, rq, acc[m].x);
          acc[m].y = fmaf(xj.y, rq, acc[m].y);
          acc[m].z = fmaf(xj.z, rq, acc[m].z);
          acc[m].w = fmaf(xj.w, rq, acc[m].w);
        }
      }
    }
#endif
    __syncthreads();  // the slot and r_s are free again
    if (tid == 0 && t + S < my_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(t + S);
    }
    const int64_t k = t / per_group;
    if (t - k * per_group == per_group - 1 || t == my_tiles - 1) {
      float4* out = reinterpret_cast<float4*>(
          a.partial + (b + k * P) * static_cast<int64_t>(H));
#pragma unroll
      for (int m = 0; m < kMaxVec; ++m) {
        const int j = tid + m * kThreads;
        if (j < nvec) out[j] = acc[m];
        acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// The bfloat16 entry. A bfloat16 is the top half of the float32 with the
// same value; a 16-byte vector holds kN = 8 of them, and a thread owns at
// most kBf16Vecs = 4 column vectors in phase (c) (8,192 columns). rho
// rounds the residual to bfloat16, to nearest even.
struct Bf16Vec {
  static constexpr int kN = 8;
  union {
    int4 raw;
    uint16_t e[kN];
  };
};
constexpr int kBf16Vecs = kMaxColumns / (Bf16Vec::kN * kThreads);

__device__ __forceinline__ float up_bf16(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ float round_bf16(float r) {
  return __bfloat162float(__float2bfloat16_rn(r));
}

// a + x . w over one vector x, in element order; w is its 8 float32
// weights, two float4s in shared memory.
__device__ __forceinline__ float dot_bf16(const Bf16Vec& x, const float4* w,
                                          float a) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float4 wp = w[p];
    a = fmaf(up_bf16(x.e[4 * p]), wp.x, a);
    a = fmaf(up_bf16(x.e[4 * p + 1]), wp.y, a);
    a = fmaf(up_bf16(x.e[4 * p + 2]), wp.z, a);
    a = fmaf(up_bf16(x.e[4 * p + 3]), wp.w, a);
  }
  return a;
}

template <class Loss, bool kHessian>
__global__ void __launch_bounds__(kThreads, 1)
    hot_pass_bf16_kernel(const Args a) {
  constexpr int kN = Bf16Vec::kN;
  constexpr int kVecs = kBf16Vecs;
  using V = Bf16Vec;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, R = a.rows, S = a.stages;
  const int nvec = H / kN;  // 16-byte vectors a row
  V* tiles = reinterpret_cast<V*>(smem);
  float4* w_s = reinterpret_cast<float4*>(tiles + static_cast<size_t>(S) *
                                                      R * nvec);
  float4* v_s = w_s + H / 4;
  float* r_s = reinterpret_cast<float*>(w_s + (kHessian ? 2 : 1) * (H / 4));
  uint64_t* bars = reinterpret_cast<uint64_t*>(r_s + kMaxRows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t P = gridDim.x;
  const uint16_t* X = reinterpret_cast<const uint16_t*>(a.X);

  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4* v4 = reinterpret_cast<const float4*>(a.v);
  for (int j = tid; j < H / 4; j += kThreads) {
    w_s[j] = w4[j];
    if (kHessian) v_s[j] = v4[j];
  }
  // This block's tiles: groups b, b + P, ..., kGroup / R tiles each; only
  // the last group of all may be short.
  const int per_group = kGroup / R;
  const int64_t my_groups = (a.groups - b + P - 1) / P;
  const int64_t last_row0 = (b + (my_groups - 1) * P) * kGroup;
  const int64_t last_rows =
      a.n - last_row0 < kGroup ? a.n - last_row0 : kGroup;
  const int64_t my_tiles = (my_groups - 1) * per_group + (last_rows + R - 1) / R;
  auto tile_row0 = [&](int64_t t) {
    const int64_t k = t / per_group;
    return (b + k * P) * kGroup + (t - k * per_group) * R;
  };
  auto tile_rows = [&](int64_t row0) {
    return static_cast<int>(a.n - row0 < R ? a.n - row0 : R);
  };
  const uint32_t row_bytes = static_cast<uint32_t>(H) * 2;
  auto issue = [&](int64_t t) {
    const int slot = static_cast<int>(t % S);
    const int64_t row0 = tile_row0(t);
    const int rows = tile_rows(row0);
    mbar_expect_tx(&bars[slot], rows * row_bytes);
    for (int q = 0; q < rows; ++q) {
      bulk_load(tiles + (static_cast<size_t>(slot) * R + q) * nvec,
                X + (row0 + q) * static_cast<int64_t>(H), row_bytes,
                &bars[slot]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int64_t t = 0; t < S && t < my_tiles; ++t) issue(t);
  }

  float acc[kVecs][kN];
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[m][k] = 0.f;
  }

  for (int64_t t = 0; t < my_tiles; ++t) {
    const int slot = static_cast<int>(t % S);
    const int64_t row0 = tile_row0(t);
    const int rows = tile_rows(row0);
    const int64_t i = row0 + warp;
    const bool mine = warp < rows;
    float off = 0.f, cz = 0.f, czv = 0.f, y = 0.f, wt = 0.f;
    if (mine) {
      off = a.offsets[i];
      y = a.labels[i];
      wt = a.weights[i];
      if (a.cold_z) cz = a.cold_z[i];
      if (kHessian && a.cold_zv) czv = a.cold_zv[i];
    }
    mbar_wait(&bars[slot], static_cast<uint32_t>((t / S) & 1));
    const V* tile = tiles + static_cast<size_t>(slot) * R * nvec;

    // (a) margins and (b) the residual: one warp a row.
    if (mine) {
      const V* x = tile + static_cast<size_t>(warp) * nvec;
      float s = 0.f, sv = 0.f;
      for (int j = lane; j < nvec; j += 32) {
        const V xj = x[j];
        s = dot_bf16(xj, w_s + j * (kN / 4), s);
        if (kHessian) sv = dot_bf16(xj, v_s + j * (kN / 4), sv);
      }
      s = warp_sum(s);
      float zi = s + off;
      if (a.cold_z) zi = zi + cz;
      float ri;
      if (kHessian) {
        sv = warp_sum(sv);
        float xvi = sv + off;
        if (a.cold_zv) xvi = xvi + czv;
        xvi = xvi - off;
        ri = (wt > 0.f ? wt * Loss::d2(zi, y) : 0.f) * xvi;
        if (lane == 0) a.xv[i] = xvi;
      } else {
        ri = wt > 0.f ? wt * Loss::dl(zi, y) : 0.f;
      }
      if (lane == 0) {
        a.z[i] = zi;
        r_s[warp] = round_bf16(ri);
      }
    }
    __syncthreads();

#ifndef HOT_PASS_TIMING_NO_TRANSPOSE
    // (c) this tile's share of X^T rho(r), row after row.
    for (int q = 0; q < rows; ++q) {
      const float rq = r_s[q];
      const V* x = tile + static_cast<size_t>(q) * nvec;
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const int j = tid + m * kThreads;
        if (j < nvec) {
          const V xj = x[j];
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            acc[m][k] = fmaf(up_bf16(xj.e[k]), rq, acc[m][k]);
          }
        }
      }
    }
#endif
    __syncthreads();  // the slot and r_s are free again
    if (tid == 0 && t + S < my_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(t + S);
    }
    const int64_t k = t / per_group;
    if (t - k * per_group == per_group - 1 || t == my_tiles - 1) {
      float4* out = reinterpret_cast<float4*>(
          a.partial + (b + k * P) * static_cast<int64_t>(H));
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const int j = tid + m * kThreads;
        if (j < nvec) {
#pragma unroll
          for (int p = 0; p < kN / 4; ++p) {
            out[j * (kN / 4) + p] =
                make_float4(acc[m][4 * p], acc[m][4 * p + 1],
                            acc[m][4 * p + 2], acc[m][4 * p + 3]);
          }
        }
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[m][e] = 0.f;
      }
    }
  }
}

// out[c] = sum of partial[g, c] over the groups: warp q adds groups q,
// q + 32, ... in order, then warp 0 adds the 32 warp sums in warp order.
__global__ void __launch_bounds__(kSumWarps * 32)
hot_pass_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int64_t groups, int H) {
  __shared__ float red[kSumWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < H) {
#pragma unroll 8
    for (int64_t g = warp; g < groups; g += kSumWarps) {
      s += partial[g * H + c];
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < H) {
    float t = red[0][lane];
#pragma unroll
    for (int q = 1; q < kSumWarps; ++q) t += red[q][lane];
    out[c] = t;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kBf16, class Loss, bool kHessian>
int launch(const Args& a, float* out, cudaStream_t stream) {
  auto kernel = kBf16 ? hot_pass_bf16_kernel<Loss, kHessian>
                      : hot_pass_kernel<Loss, kHessian>;
  // Once a process: allow the kernel the opt-in shared memory.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t bytes =
      shared_bytes(a.H, a.rows, a.stages, kHessian, kBf16 ? 2 : 4);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t grid = a.groups < resident ? a.groups : resident;
  if constexpr (kBf16) {
    hot_pass_bf16_kernel<Loss, kHessian>
        <<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(a);
  } else {
    hot_pass_kernel<Loss, kHessian>
        <<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hot_pass_sum_kernel<<<(a.H + 31) / 32, kSumWarps * 32, 0, stream>>>(
      a.partial, out, a.groups, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, bool kHessian>
int dispatch(int loss, const Args& a, float* out, cudaStream_t stream) {
  switch (loss) {
    case 0: return launch<kBf16, Logistic, kHessian>(a, out, stream);
    case 1: return launch<kBf16, Squared, kHessian>(a, out, stream);
    case 2: return launch<kBf16, Poisson, kHessian>(a, out, stream);
    case 3: return launch<kBf16, SmoothedHinge, kHessian>(a, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The C entries' common body: checks, then the pass (bfloat16 X with
// kBf16, float32 X without).
template <bool kBf16>
int run(const void* X, const void* w, const void* v, const void* offsets,
        const void* cold_z, const void* cold_zv, const void* labels,
        const void* weights, void* z, void* xv, void* partial, void* out,
        long long n, int H, int rows, int stages, long long groups,
        int loss, void* stream) {
  const int per_vec = kBf16 ? 8 : 4;  // columns in 16 bytes
  const bool hessian = v != nullptr;
  if (n < 1 || groups != (n + kGroup - 1) / kGroup || H < per_vec ||
      H % per_vec || H > kMaxColumns || rows < 1 || rows > kMaxRows ||
      kGroup % rows != 0 || stages < 2 || stages > kMaxStages ||
      shared_bytes(H, rows, stages, hessian, kBf16 ? 2 : 4) > kMaxShared ||
      (hessian && xv == nullptr) || !aligned16(X) || !aligned16(w) ||
      (hessian && !aligned16(v)) || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.X = static_cast<const float*>(X);
  a.w = static_cast<const float*>(w);
  a.v = static_cast<const float*>(v);
  a.offsets = static_cast<const float*>(offsets);
  a.cold_z = static_cast<const float*>(cold_z);
  a.cold_zv = static_cast<const float*>(cold_zv);
  a.labels = static_cast<const float*>(labels);
  a.weights = static_cast<const float*>(weights);
  a.z = static_cast<float*>(z);
  a.xv = static_cast<float*>(xv);
  a.partial = static_cast<float*>(partial);
  a.n = n;
  a.groups = groups;
  a.H = H;
  a.rows = rows;
  a.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return hessian ? dispatch<kBf16, true>(loss, a, o, s)
                 : dispatch<kBf16, false>(loss, a, o, s);
}

}  // namespace

extern "C" {

// One pass over X (n, H), rows contiguous on 16 bytes: float32 with H a
// multiple of 4 (hot_pass_f32), or bfloat16 with H a multiple of 8
// (hot_pass_bf16), H at most 8,192. w and v are float32 (rounded to
// bfloat16 values by the caller for a bfloat16 X). loss: 0 logistic, 1
// squared, 2 Poisson, 3 smoothed hinge. v null: value and gradient (z,
// out = X^T rho(r)); v set: H.v (z, xv, out), xv then (n,). partial is a
// (groups, H) float32 scratch, groups = ceil(n / 512), n >= 1. rows (1..8)
// and stages (2..8) are the tile ring's geometry; its shared memory must
// fit a block.
int hot_pass_f32(const void* X, const void* w, const void* v,
                 const void* offsets, const void* cold_z, const void* cold_zv,
                 const void* labels, const void* weights, void* z, void* xv,
                 void* partial, void* out, long long n, int H, int rows,
                 int stages, long long groups, int loss, void* stream) {
  return run<false>(X, w, v, offsets, cold_z, cold_zv, labels, weights, z,
                    xv, partial, out, n, H, rows, stages, groups, loss,
                    stream);
}

int hot_pass_bf16(const void* X, const void* w, const void* v,
                  const void* offsets, const void* cold_z,
                  const void* cold_zv, const void* labels,
                  const void* weights, void* z, void* xv, void* partial,
                  void* out, long long n, int H, int rows, int stages,
                  long long groups, int loss, void* stream) {
  return run<true>(X, w, v, offsets, cold_z, cold_zv, labels, weights,
                       z, xv, partial, out, n, H, rows, stages, groups, loss,
                       stream);
}

}  // extern "C"
