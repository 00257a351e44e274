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
// flops, so bytes still bound it: at config 5's 9.5M rows (threshold
// n/4096: H = 3,016) X is 57.30 GB, 17.16 ms (17.19 for H.v); its 4 n H
// (6 n H) flops take 1.7 (2.6) ms.
//
// Both entries.
// - A persistent grid (at most the blocks the card holds at once) walks
//   fixed groups of kGroup = 512 rows: block b takes groups b, b + P, ...
//   Each group gives one partial row of g, written to partial[group, :];
//   a second launch adds the partials in group order. No atomics: every
//   sum's order is fixed by n and H alone, not by the grid or by
//   scheduling, so two launches give the same bits.
// - A ring of S tiles of R rows in dynamic shared memory: the wrapper
//   picks the most rows up to R = 8, then the most tiles S >= 2, that fit
//   the 227 KB a block may hold (shared_bytes). Rows are a multiple of 16
//   bytes (H a multiple of 4 float32 or 8 bfloat16 columns) and are
//   filled by bulk copies (cp.async.bulk) completing on the slot's
//   mbarrier. A block's ring runs on from one group to the next.
// - (a) Margins, in exactly hot_margins_kernel's order
//   (csrc/stream_fused.cu): lane l of the warp that takes a row owns its
//   16-byte vectors l, l + 32, ... (4 float32 or 8 bfloat16 elements
//   each, a bfloat16 widened to float32 in registers) and adds their
//   products with fmaf in element order, the xor butterfly 16 .. 1 adds
//   the lane sums, then + offsets[i], then + cold_z[i]. So z equals the
//   two-kernel route's hot_margins + scatter bit for bit, for either
//   element type, and so does x.v.
// - (b) The residual, from the loss's device policy: the formulas of
//   photon_ml_torch/ops/losses.py, with each product that feeds an add
//   rounded on its own (__fmul_rn), so no contraction changes the bits.
//   Over a bfloat16 block it is then rounded to bfloat16 (rho).
// - (c) The transposed product: a thread owns fixed 16-byte column
//   vectors as float32 sums in registers and adds x * rho(r[i]) with
//   fmaf, tile row after tile row.
//
// The float32 entry (hot_pass_kernel; R = 8, S = 3 at H = 1,772): one
// block of 8 warps an SM; thread 0 fills a tile with one bulk copy a row
// and refills a slot once the block has used it. Warp q takes tile row q
// in (a) and (b), then, after a __syncthreads, thread t owns the column
// vectors t, t + 256, ... in (c), and a second __syncthreads frees the
// slot. Each row's terms are loaded before the wait on its tile. It runs
// at 91% of its bound (PERF.md).
//
// The bfloat16 entry (hot_pass_bf16_kernel; R = 8, S = 4 at H = 3,016).
// The float32 entry's loop over 16-bit elements ran at 55.6% (value and
// gradient, 30.84 ms) and 46.3% (H.v, 37.12 ms) of the bound at 9.5M x
// 3,016. Timed at other ring shapes and without phase (c)
// (dev-scripts/exp_hot_pass_bf16.py): two blocks an SM, where the ring
// left room for them, took value and gradient to 20.45 ms, so the two
// phases, serialised by the block's barriers, cost more than the bytes;
// H.v's margins alone took 25.7 ms, since every row read float32 w and v
// from shared memory with two-way bank conflicts (18 bytes of shared
// traffic an element against the ring's 2); at 4-row tiles one warp a
// row left half the block idle. So:
// - Warp roles, no block-wide barrier after set-up. Warp 0's thread 0 is
//   the producer: one bulk copy a tile (its R rows lie back to back in
//   X), into a slot that its "empty" mbarrier says is read. Warps 1-4 run
//   (a) and (b) and hand rho(r) over in the slot's array of R floats,
//   then arrive on its "ready" mbarrier; warps 5-8 run (c) on the slot,
//   then arrive on "empty". The margins of the next tiles run while the
//   transposed product of the current one does, S - 1 tiles ahead at
//   most.
// - w and v are kept in shared memory as bfloat16 (exact: the caller
//   rounded them), half the bytes, read with conflict-free 16-byte loads.
// - Margin warp q takes tile rows q and q + 4 at once: each vector of w
//   (and v) is read and widened once for both rows, and each lane runs
//   two (H.v: four) independent fmaf chains. The next vectors of x, w and
//   v are loaded before the current products; each row's terms are
//   loaded a tile ahead.
// - Phase (c): thread c of the 128 owns the column vectors c, c + 128,
//   ..., at most kVecs (a template: 4 up to H = 4,096, else 8); a full
//   tile's 8 rows run in an unrolled loop.
// - The loss is picked a row at run time (one uniform branch), so the
//   entry builds four kernels (mode x kVecs), not sixteen.
// - The ring's depth: ring_shape gives a bfloat16 block the most tiles
//   that leave room for two blocks an SM (8 x 2 at H = 3,016, 18 warps an
//   SM), which beat one block with a deeper ring.
// Per element the pass then reads 2 bytes of x in (a), 2 in (c) and 1 of
// w (and of v) from shared memory, beside the ring's 2-byte fill.
//
// HOT_PASS_TIMING_NO_TRANSPOSE, defined only by the timing harnesses
// (chip_smoke.py, dev-scripts/exp_hot_pass_bf16.py) in a build of their
// own, leaves phase (c) out of either entry, to show what the transposed
// product costs inside the pass. The package never defines it.
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
  int loss;    // the bfloat16 entry's loss id (LOSSES order)
};

// The ring's rows hold ``itemsize``-byte elements. Float32 (4): the ring,
// float32 w (and v), the tile's residuals and one mbarrier a slot.
// Bfloat16 (2): the ring, bfloat16 w (and v), each slot's residuals and
// three mbarriers a slot (full, ready, empty).
__host__ __device__ constexpr size_t shared_bytes(int H, int R, int S,
                                                  bool hessian,
                                                  int itemsize = 4) {
  return itemsize == 2
             ? static_cast<size_t>(S) * R * H * 2 + (hessian ? 2 : 1) * H * 2 +
                   S * kMaxRows * 4 + 3 * S * 8
             : static_cast<size_t>(S) * R * H * 4 + (hessian ? 2 : 1) * H * 4 +
                   kMaxRows * 4 + S * 8;
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

// The bfloat16 entry (the design note at the top). A bfloat16 is the
// top half of the float32 with the same value, so a 32-bit word of two
// bfloat16s widens to two floats with one shift or one mask: element 2k
// is the low half of word k. A 16-byte vector holds 8 of them.
constexpr int kBf16N = 8;
constexpr int kMarginWarps = 4;    // phases (a) and (b)
constexpr int kTransposeWarps = 4;  // phase (c)
constexpr int kBf16Threads = 32 * (1 + kMarginWarps + kTransposeWarps);
constexpr int kTransposeThreads = 32 * kTransposeWarps;
// A margin warp takes tile rows q and q + kMarginWarps at once.
static_assert(kMaxRows == 2 * kMarginWarps, "two rows a margin warp");
// Column vectors a phase (c) thread owns, at most (8,192 columns).
constexpr int kBf16MaxVecs = kMaxColumns / (kBf16N * kTransposeThreads);

__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float round_bf16(float r) {
  return __bfloat162float(__float2bfloat16_rn(r));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}

// The 8 floats of a 16-byte vector of bfloat16s, in element order.
__device__ __forceinline__ void widen(const uint4 u, float (&f)[kBf16N]) {
  f[0] = lo_bf16(u.x); f[1] = hi_bf16(u.x);
  f[2] = lo_bf16(u.y); f[3] = hi_bf16(u.y);
  f[4] = lo_bf16(u.z); f[5] = hi_bf16(u.z);
  f[6] = lo_bf16(u.w); f[7] = hi_bf16(u.w);
}

// a + x . w over one vector x, in element order.
__device__ __forceinline__ float dot_bf16(const uint4 x,
                                          const float (&w)[kBf16N],
                                          float a) {
  a = fmaf(lo_bf16(x.x), w[0], a);
  a = fmaf(hi_bf16(x.x), w[1], a);
  a = fmaf(lo_bf16(x.y), w[2], a);
  a = fmaf(hi_bf16(x.y), w[3], a);
  a = fmaf(lo_bf16(x.z), w[4], a);
  a = fmaf(hi_bf16(x.z), w[5], a);
  a = fmaf(lo_bf16(x.w), w[6], a);
  return fmaf(hi_bf16(x.w), w[7], a);
}

// The bfloat16 entry's loss, picked at run time (one uniform branch a
// row): one kernel a mode and width keeps the source's build short.
__device__ __forceinline__ float loss_dl(int loss, float z, float y) {
  switch (loss) {
    case 0: return Logistic::dl(z, y);
    case 1: return Squared::dl(z, y);
    case 2: return Poisson::dl(z, y);
    default: return SmoothedHinge::dl(z, y);
  }
}

__device__ __forceinline__ float loss_d2(int loss, float z, float y) {
  switch (loss) {
    case 0: return Logistic::d2(z, y);
    case 1: return Squared::d2(z, y);
    case 2: return Poisson::d2(z, y);
    default: return SmoothedHinge::d2(z, y);
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Phase (a) for one margin warp: the lane sums of rows x0 (and, kTwo, x1)
// against w (and, kHessian, v), lane l over the vectors l, l + 32, ...
// The next vectors are loaded before the current ones are used.
template <bool kHessian, bool kTwo>
__device__ __forceinline__ void lane_dots(const uint4* x0, const uint4* x1,
                                          const uint4* w_s, const uint4* v_s,
                                          int nvec, int lane, float (&s)[2],
                                          float (&sv)[2]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xa = zero, xb = zero, wq = zero, vq = zero;
  int j = lane;
  if (j < nvec) {
    xa = x0[j];
    if (kTwo) xb = x1[j];
    wq = w_s[j];
    if (kHessian) vq = v_s[j];
  }
  for (; j < nvec; j += 32) {
    const int jn = j + 32;
    uint4 xa_n = zero, xb_n = zero, wq_n = zero, vq_n = zero;
    if (jn < nvec) {
      xa_n = x0[jn];
      if (kTwo) xb_n = x1[jn];
      wq_n = w_s[jn];
      if (kHessian) vq_n = v_s[jn];
    }
    float wf[kBf16N];
    widen(wq, wf);
    s[0] = dot_bf16(xa, wf, s[0]);
    if (kTwo) s[1] = dot_bf16(xb, wf, s[1]);
    if (kHessian) {
      float vf[kBf16N];
      widen(vq, vf);
      sv[0] = dot_bf16(xa, vf, sv[0]);
      if (kTwo) sv[1] = dot_bf16(xb, vf, sv[1]);
    }
    xa = xa_n;
    xb = xb_n;
    wq = wq_n;
    vq = vq_n;
  }
}

// One row's terms, fetched a tile ahead of its use.
struct RowTerms {
  float off, cz, czv, y, wt;
};

__device__ __forceinline__ RowTerms row_terms(const Args& a, int64_t i,
                                              bool hessian) {
  RowTerms t;
  t.off = a.offsets[i];
  t.y = a.labels[i];
  t.wt = a.weights[i];
  t.cz = a.cold_z ? a.cold_z[i] : 0.f;
  t.czv = hessian && a.cold_zv ? a.cold_zv[i] : 0.f;
  return t;
}

// Phase (c) for one tile row: acc[m] += x[c + m * 128] * rq.
template <int kVecs>
__device__ __forceinline__ void add_row(const uint4* x, float rq, int c,
                                        int nvec,
                                        float (&acc)[kVecs][kBf16N]) {
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    const int j = c + m * kTransposeThreads;
    if (j < nvec) {
      const uint4 u = x[j];
      acc[m][0] = fmaf(lo_bf16(u.x), rq, acc[m][0]);
      acc[m][1] = fmaf(hi_bf16(u.x), rq, acc[m][1]);
      acc[m][2] = fmaf(lo_bf16(u.y), rq, acc[m][2]);
      acc[m][3] = fmaf(hi_bf16(u.y), rq, acc[m][3]);
      acc[m][4] = fmaf(lo_bf16(u.z), rq, acc[m][4]);
      acc[m][5] = fmaf(hi_bf16(u.z), rq, acc[m][5]);
      acc[m][6] = fmaf(lo_bf16(u.w), rq, acc[m][6]);
      acc[m][7] = fmaf(hi_bf16(u.w), rq, acc[m][7]);
    }
  }
}

template <bool kHessian, int kVecs>
__global__ void __launch_bounds__(kBf16Threads, 1)
    hot_pass_bf16_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, R = a.rows, S = a.stages;
  const int nvec = H / kBf16N;  // 16-byte vectors a row
  uint4* tiles = reinterpret_cast<uint4*>(smem);
  uint4* w_s = tiles + static_cast<size_t>(S) * R * nvec;
  uint4* v_s = w_s + nvec;
  float* r_s = reinterpret_cast<float*>(w_s + (kHessian ? 2 : 1) * nvec);
  uint64_t* full = reinterpret_cast<uint64_t*>(r_s + S * kMaxRows);
  uint64_t* ready = full + S;  // the slot's rho(r) is written
  uint64_t* empty = ready + S;  // the slot is read
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t P = gridDim.x;

  // w and v as bfloat16 (exact: the caller rounded them).
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  const float4* v4 = reinterpret_cast<const float4*>(a.v);
  for (int j = tid; j < nvec; j += kBf16Threads) {
    float4 p = w4[2 * j], q = w4[2 * j + 1];
    w_s[j] = make_uint4(pack_bf16(p.x, p.y), pack_bf16(p.z, p.w),
                        pack_bf16(q.x, q.y), pack_bf16(q.z, q.w));
    if (kHessian) {
      p = v4[2 * j];
      q = v4[2 * j + 1];
      v_s[j] = make_uint4(pack_bf16(p.x, p.y), pack_bf16(p.z, p.w),
                          pack_bf16(q.x, q.y), pack_bf16(q.z, q.w));
    }
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kMarginWarps);
      mbar_init(&empty[s], kTransposeWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  // This block's tiles: groups b, b + P, ..., kGroup / R tiles each; only
  // the last group of all may be short.
  const int per_group = kGroup / R;
  const int64_t my_groups = (a.groups - b + P - 1) / P;
  const int64_t last_row0 = (b + (my_groups - 1) * P) * kGroup;
  const int64_t last_rows =
      a.n - last_row0 < kGroup ? a.n - last_row0 : kGroup;
  const int64_t my_tiles =
      (my_groups - 1) * per_group + (last_rows + R - 1) / R;
  auto tile_row0 = [&](int64_t t) {
    const int64_t k = t / per_group;
    return (b + k * P) * kGroup + (t - k * per_group) * R;
  };
  auto tile_rows = [&](int64_t row0) {
    return static_cast<int>(a.n - row0 < R ? a.n - row0 : R);
  };

  if (warp == 0) {
    // The producer: one bulk copy a tile (its rows lie back to back in
    // X), into a slot the block has finished reading.
    if (lane == 0) {
      const uint16_t* X = reinterpret_cast<const uint16_t*>(a.X);
      const uint32_t row_bytes = static_cast<uint32_t>(H) * 2;
      for (int64_t t = 0; t < my_tiles; ++t) {
        const int slot = static_cast<int>(t % S);
        const int64_t k = t / S;
        if (k > 0) {
          mbar_wait(&empty[slot], static_cast<uint32_t>((k - 1) & 1));
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        const int64_t row0 = tile_row0(t);
        const uint32_t bytes = tile_rows(row0) * row_bytes;
        mbar_expect_tx(&full[slot], bytes);
        bulk_load(tiles + static_cast<size_t>(slot) * R * nvec,
                  X + row0 * static_cast<int64_t>(H), bytes, &full[slot]);
      }
    }
  } else if (warp <= kMarginWarps) {
    // (a) margins and (b) the residual: warp q takes tile rows q and
    // q + kMarginWarps, each in hot_margins' order.
    const int q = warp - 1;
    RowTerms cur[2] = {}, nxt[2] = {};
    auto fetch = [&](int64_t t, RowTerms (&out)[2]) {
      const int64_t row0 = tile_row0(t);
      const int rows = tile_rows(row0);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int row = q + p * kMarginWarps;
        if (row < rows) out[p] = row_terms(a, row0 + row, kHessian);
      }
    };
    fetch(0, cur);
    for (int64_t t = 0; t < my_tiles; ++t) {
      const int slot = static_cast<int>(t % S);
      const int64_t row0 = tile_row0(t);
      const int rows = tile_rows(row0);
      if (t + 1 < my_tiles) fetch(t + 1, nxt);
      mbar_wait(&full[slot], static_cast<uint32_t>((t / S) & 1));
      if (q < rows) {
        const uint4* tile = tiles + static_cast<size_t>(slot) * R * nvec;
        const uint4* x0 = tile + static_cast<size_t>(q) * nvec;
        const uint4* x1 = x0 + static_cast<size_t>(kMarginWarps) * nvec;
        const bool two = q + kMarginWarps < rows;
        float s[2] = {0.f, 0.f}, sv[2] = {0.f, 0.f};
        if (two) {
          lane_dots<kHessian, true>(x0, x1, w_s, v_s, nvec, lane, s, sv);
        } else {
          lane_dots<kHessian, false>(x0, x1, w_s, v_s, nvec, lane, s, sv);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int row = q + p * kMarginWarps;
          if (row < rows) {
            const RowTerms& u = cur[p];
            const int64_t i = row0 + row;
            float zi = warp_sum(s[p]) + u.off;
            if (a.cold_z) zi = zi + u.cz;
            float ri;
            if (kHessian) {
              float xvi = warp_sum(sv[p]) + u.off;
              if (a.cold_zv) xvi = xvi + u.czv;
              xvi = xvi - u.off;
              ri = (u.wt > 0.f ? u.wt * loss_d2(a.loss, zi, u.y) : 0.f) *
                   xvi;
              if (lane == 0) a.xv[i] = xvi;
            } else {
              ri = u.wt > 0.f ? u.wt * loss_dl(a.loss, zi, u.y) : 0.f;
            }
            if (lane == 0) {
              a.z[i] = zi;
              r_s[slot * kMaxRows + row] = round_bf16(ri);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[slot]);
      cur[0] = nxt[0];
      cur[1] = nxt[1];
    }
  } else {
    // (c) the transposed product: thread c owns the column vectors c,
    // c + 128, ... and adds x * rho(r) tile row after tile row.
    const int c = tid - 32 * (1 + kMarginWarps);
    float acc[kVecs][kBf16N];
#pragma unroll
    for (int m = 0; m < kVecs; ++m) {
#pragma unroll
      for (int e = 0; e < kBf16N; ++e) acc[m][e] = 0.f;
    }
    for (int64_t t = 0; t < my_tiles; ++t) {
      const int slot = static_cast<int>(t % S);
      const uint32_t parity = static_cast<uint32_t>((t / S) & 1);
      const int64_t row0 = tile_row0(t);
      const int rows = tile_rows(row0);
      mbar_wait(&full[slot], parity);
      mbar_wait(&ready[slot], parity);
#ifndef HOT_PASS_TIMING_NO_TRANSPOSE
      const uint4* tile = tiles + static_cast<size_t>(slot) * R * nvec;
      const float* r = r_s + slot * kMaxRows;
      if (rows == kMaxRows) {
#pragma unroll
        for (int row = 0; row < kMaxRows; ++row) {
          add_row<kVecs>(tile + static_cast<size_t>(row) * nvec, r[row], c,
                         nvec, acc);
        }
      } else {
#pragma unroll 1
        for (int row = 0; row < rows; ++row) {
          add_row<kVecs>(tile + static_cast<size_t>(row) * nvec, r[row], c,
                         nvec, acc);
        }
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      const int64_t k = t / per_group;
      if (t - k * per_group == per_group - 1 || t == my_tiles - 1) {
        float4* out = reinterpret_cast<float4*>(
            a.partial + (b + k * P) * static_cast<int64_t>(H));
#pragma unroll
        for (int m = 0; m < kVecs; ++m) {
          const int j = c + m * kTransposeThreads;
          if (j < nvec) {
            out[2 * j] = make_float4(acc[m][0], acc[m][1], acc[m][2],
                                     acc[m][3]);
            out[2 * j + 1] = make_float4(acc[m][4], acc[m][5], acc[m][6],
                                         acc[m][7]);
          }
#pragma unroll
          for (int e = 0; e < kBf16N; ++e) acc[m][e] = 0.f;
        }
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

// One pass: ``kernel`` over a persistent grid (at most the blocks the card
// holds at once, and no more than the groups), then the ordered sum of its
// partial rows.
int launch_pass(void (*kernel)(Args), cudaError_t attr, int threads,
                size_t bytes, const Args& a, float* out,
                cudaStream_t stream) {
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t grid = a.groups < resident ? a.groups : resident;
  kernel<<<static_cast<unsigned>(grid), threads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hot_pass_sum_kernel<<<(a.H + 31) / 32, kSumWarps * 32, 0, stream>>>(
      a.partial, out, a.groups, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <class Loss, bool kHessian>
int launch_f32(const Args& a, float* out, cudaStream_t stream) {
  // Once a process: allow the kernel the opt-in shared memory.
  static const cudaError_t attr =
      cudaFuncSetAttribute(hot_pass_kernel<Loss, kHessian>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxShared);
  return launch_pass(hot_pass_kernel<Loss, kHessian>, attr, kThreads,
                     shared_bytes(a.H, a.rows, a.stages, kHessian, 4), a,
                     out, stream);
}

template <bool kHessian, int kVecs>
int launch_bf16(const Args& a, float* out, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(hot_pass_bf16_kernel<kHessian, kVecs>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxShared);
  return launch_pass(hot_pass_bf16_kernel<kHessian, kVecs>, attr,
                     kBf16Threads,
                     shared_bytes(a.H, a.rows, a.stages, kHessian, 2), a,
                     out, stream);
}

template <bool kBf16, bool kHessian>
int dispatch(int loss, const Args& a, float* out, cudaStream_t stream) {
  if constexpr (kBf16) {
    // Phase (c) holds 4 column vectors a thread up to 4,096 columns (few
    // enough registers for two blocks an SM), else 8.
    if (loss < 0 || loss > 3) return static_cast<int>(cudaErrorInvalidValue);
    return a.H / kBf16N <= 4 * kTransposeThreads
               ? launch_bf16<kHessian, 4>(a, out, stream)
               : launch_bf16<kHessian, kBf16MaxVecs>(a, out, stream);
  } else {
    switch (loss) {
      case 0: return launch_f32<Logistic, kHessian>(a, out, stream);
      case 1: return launch_f32<Squared, kHessian>(a, out, stream);
      case 2: return launch_f32<Poisson, kHessian>(a, out, stream);
      case 3: return launch_f32<SmoothedHinge, kHessian>(a, out, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
  a.loss = loss;
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
