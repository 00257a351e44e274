// stream_fused: the hot tier of a row-streamed sparse chunk, for NVIDIA
// Hopper (sm_90a). Two functions over the chunk's dense hot block X (n, H),
// stored as int8 codes, bfloat16 or float32:
//
//   hot_margins:  out[i] = base[i] + sum_h f32(X[i, h]) * w[h]
//   hot_rmatvec:  out[h] = sum_i f32(X[i, h]) * r[i]   (unscaled)
//
// They replace the TPU kernels photon_ml_tpu/ops/kernels/stream_fused.py
// hot_margins_pallas (pl.pallas_call at :77, body _margins_kernel :49) and
// hot_rmatvec_pallas (:123, body _rmatvec_kernel :100). The Pallas programs
// exist to upcast the codes inside the tiles, so the (n, H) float32 copy of
// the densest block never exists in device memory; these kernels do the same
// in registers. The int8 dequantisation scales stay with the caller: the
// margins caller folds them into w, the gradient caller multiplies the (H,)
// result once.
//
// Bound on the H100 (3.35 TB/s). Both read X once (n * H * itemsize bytes)
// and a few (n,) or (H,) float32 vectors; they do 2 * n * H flops, far
// below the float32 rate, so bytes bound them. At the streamed chunk
// (n = 262,144, H = 512) margins moves about 136.3 MB (40.7 us) in int8,
// 538.9 MB (160.9 us) in float32; rmatvec about 135.3 MB (40.4 us) and
// 537.9 MB (160.6 us).
//
// Two routes, chosen by the launcher's caller from the shape before any
// launch (stream_fused.route in the wrapper), never by a failure:
// - the ring route, for float32 blocks whose rows are a whole number of 16
//   bytes (H % 4 == 0), whose base is 16-byte aligned and whose H is at
//   most kMaxColumns = 8,192 (the C entries *_f32_ring, which refuse any
//   other block with cudaErrorInvalidValue);
// - the direct route, for every other block: int8 and bfloat16 always,
//   float32 with a ragged H, a misaligned base or H > 8,192 (the C entries
//   hot_margins_{i8,bf16,f32}, hot_rmatvec_{i8,bf16,f32}).
// Both routes give hot_margins the same bits. hot_rmatvec's two routes sum
// in different fixed orders.
//
// Direct hot_margins. One warp per row, 8 warps and 64 rows a block. w is
// staged in shared memory in tiles of 4,096 floats. Lane l owns the
// 16-byte vectors l, l + 32, l + 64, ... of the row (V = 16 / itemsize
// elements each) and adds their products into its float32 sum with fmaf,
// in increasing element order; a __shfl_xor_sync butterfly (16, 8, 4, 2,
// 1) then adds the 32 lane sums (a commutative pair a step, so every lane
// ends with the same bits), and base[i] is added last. Rows whose length in
// bytes is a multiple of 16 load 16 bytes at a time; others (H = 37, say)
// load element by element in the same lane and order, so the bits do not
// depend on the path. The w tile is stored as V planes, element k of every
// vector in plane k (each plane padded by one float): at each step the 32
// lanes read 32 neighbouring floats of one plane. Stored in row order, lane
// l's element k sat at 16 l + k, and for int8 the 32 lanes hit two banks:
// a 16-way conflict (8-way for bfloat16, 4-way for float32) that held the
// int8 kernel at 0.280 ms against its 0.041 ms bound (NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// Direct hot_rmatvec. The rows are cut into tiles of kRowTile = 512; the
// columns into groups of 32 * V (one 16-byte vector a lane). Pass 1: one
// block per (row tile, column group). Warp w adds rows w, w + 8, ... of
// the tile into V float32 sums a lane (fmaf, in row order); the 8 warp
// sums of each column are then added in warp order through shared memory
// and written to partial[tile, column]. Pass 2: one block per 32 columns;
// warp w adds the tiles w, w + 8, ... in order, and lane 0..31 of warp 0
// adds the 8 warp sums in order. At the streamed chunk pass 1 runs 512
// blocks where one block per column tile would run one.
//
// The ring route. The direct float32 kernels read X with plain 16-byte
// loads, each warp waiting on its own; they reached 75% (margins) and 89%
// (rmatvec) of the bound at the streamed chunk, behind torch.addmv and
// torch.mv. The ring route follows csrc/hot_pass.cu's loader (its helpers
// copied here, not shared: the build hashes this file alone):
// - A persistent grid, at most the blocks the card holds at once. Each
//   block keeps a ring of S tiles of R rows in dynamic shared memory
//   (R <= 8, 2 <= S <= 8), a max(H, 1024)-float scratch and S mbarriers,
//   within the 227 KB a block may hold. The wrapper's ring_shape picks
//   S tiles of the most rows up to 8 that fit, S = 3 for hot_margins and
//   2 for hot_rmatvec ((8, 3) and (8, 2) at H = 512 and 1,772; (2, 3) and
//   (2, 2) at 8,192): several blocks an SM with shallow rings kept the
//   card's memory busier than one block with a deep ring, which waits for
//   all its warps before it refills a slot.
// - Thread 0 fills a slot with one cp.async.bulk (a tile's rows lie back
//   to back in X), completing on the slot's mbarrier, and refills it as
//   soon as the block has used it, so S - 1 tiles are in flight while one
//   is read. The ring runs on from one row group to the next.
// - hot_margins: blocks of 32 R threads; block b takes the tiles b,
//   b + P, ... (R rows each, only the last one short). Warp q takes row q
//   of the tile out of shared memory in exactly the direct kernel's
//   order: lane l owns the 16-byte vectors l, l + 32, ..., adds their
//   products with fmaf in element order, the butterfly 16 .. 1 adds the
//   lane sums, base[i] is added last. So both routes give the same bits,
//   and so does hot_pass's z. base of the next tile's rows is loaded
//   while the current one is read. At H <= 512 lane l keeps its own (at
//   most four) vectors of w in registers for the whole kernel (vector j
//   stays with lane j % 32); wider rows read w from the shared scratch.
// - hot_rmatvec: blocks of 128 threads. The rows are cut into G =
//   ceil(n / 512) fixed groups of 512 / R tiles: group g holds the R-row
//   tiles g, g + G, g + 2 G, ... of X (512 rows where n is a multiple of
//   512; a tile past n is short or empty), so at any moment the blocks
//   read neighbouring tiles, not P streams 512 rows apart. Block b takes
//   the groups b, b + P, ...; each group gives one partial row,
//   partial[group, :]. The block's threads form `splits` splits of
//   C = 128 / splits threads: the most splits (a power of two
//   up to min(8, R)) that leave C at least the row's H / 4 16-byte
//   vectors (one split from H = 260 up). Thread c of split s owns the
//   vectors c, c + C, ... (at most 16) and adds x * r[i] with fmaf over
//   the rows of the group's tiles, tile after tile and, in a tile, rows
//   s, s + splits, ...; r of the next tile is loaded while the current
//   one is read. At the group's end the splits' sums are added in split
//   order through the shared scratch and written out. A second launch,
//   the direct route's pass 2 with 32 warps, adds the partial rows in
//   group order: warp q adds groups q, q + 32, ..., then warp 0 adds the
//   32 warp sums in warp order.
// No atomics on either route: every sum's order is fixed by n and H alone
// (R and the splits follow from H), not by the grid or by scheduling, so
// two launches give the same bits.
//
// Offsets: n is int64 and every element offset is formed in int64
// (n * H passes 2^31 at a larger chunk_rows). The wrapper allocates out
// and the (ceil(n / 512), H) partials.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape or geometry it refuses.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kWTile = 4096;  // floats of w in shared memory at a time
constexpr int kRowTile = 512;  // rows per hot_rmatvec tile

// Storage types: int8 codes, bfloat16 as its 16 bits, float32. A
// bfloat16 is the top half of the float32 with the same value.
__device__ __forceinline__ float up(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float up(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ float up(float x) { return x; }

// One 16-byte load of V = 16 / sizeof(T) elements.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  union {
    int4 raw;
    T e[kN];
  };
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
hot_margins_kernel(const T* __restrict__ X, const float* __restrict__ w,
                   const float* __restrict__ base, float* __restrict__ out,
                   int64_t n, int H, bool vec) {
  constexpr int V = Vec<T>::kN;
  constexpr int kPlane = kWTile / V + 1;  // tile element q at plane q % V
  __shared__ float w_s[V * kPlane];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.0f;
  for (int t0 = 0; t0 < H; t0 += kWTile) {
    const int t1 = min(H, t0 + kWTile);
    __syncthreads();
    for (int h = t0 + threadIdx.x; h < t1; h += kThreads) {
      const int q = h - t0;
      w_s[(q % V) * kPlane + q / V] = w[h];
    }
    __syncthreads();
    // kWTile / V is a multiple of 32, so vector j stays with lane j % 32
    // from one tile to the next.
    const int j0 = t0 / V + lane;
    const int j1 = (t1 + V - 1) / V;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int64_t row = row0 + r * kWarps + warp;
      if (row >= n) continue;
      const T* x = X + row * static_cast<int64_t>(H);
      float a = acc[r];
      for (int j = j0; j < j1; j += 32) {
        const int e0 = j * V;
        const float* ws = w_s + (j - t0 / V);  // plane 0 of vector j
        if (vec) {
          Vec<T> v;
          v.raw = *reinterpret_cast<const int4*>(x + e0);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            a = fmaf(up(v.e[k]), ws[k * kPlane], a);
          }
        } else {
          const int e1 = min(e0 + V, t1);
          for (int e = e0; e < e1; ++e) {
            a = fmaf(up(x[e]), ws[(e - e0) * kPlane], a);
          }
        }
      }
      acc[r] = a;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float a = acc[r];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, offset);
    }
    const int64_t row = row0 + r * kWarps + warp;
    if (lane == 0 && row < n) out[row] = a + base[row];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hot_rmatvec_tiles_kernel(const T* __restrict__ X, const float* __restrict__ r,
                         float* __restrict__ partial, int64_t n, int H,
                         bool vec) {
  constexpr int V = Vec<T>::kN;
  constexpr int kGroup = 32 * V;  // columns of one group
  __shared__ float red[kWarps][kGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  const int c0 = blockIdx.y * kGroup + lane * V;  // this lane's columns
  const int64_t i0 = tile * kRowTile;
  const int64_t i1 = n < i0 + kRowTile ? n : i0 + kRowTile;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  if (c0 < H) {
    // With vec, H is a multiple of V, so a lane's vector is whole.
    for (int64_t i = i0 + warp; i < i1; i += kWarps) {
      const T* x = X + i * static_cast<int64_t>(H) + c0;
      const float ri = r[i];
      if (vec) {
        Vec<T> v;
        v.raw = *reinterpret_cast<const int4*>(x);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(up(v.e[k]), ri, acc[k]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (c0 + k < H) acc[k] = fmaf(up(x[k]), ri, acc[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) red[warp][lane * V + k] = acc[k];
  __syncthreads();
  for (int q = threadIdx.x; q < kGroup; q += kThreads) {
    const int c = blockIdx.y * kGroup + q;
    if (c >= H) continue;
    float s = red[0][q];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += red[k][q];
    partial[tile * H + c] = s;
  }
}

// out[c] = sum of partial[t, c] over the tiles (or groups): warp w of
// kSumWarps adds tiles w, w + kSumWarps, ... in order, then warp 0 adds
// the warp sums in warp order. The direct route runs 8 warps, the ring
// route 32.
template <int kSumWarps>
__global__ void __launch_bounds__(kSumWarps * 32)
hot_rmatvec_sum_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int64_t tiles, int H) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < H) {
#pragma unroll 8
    for (int64_t t = warp; t < tiles; t += kSumWarps) s += partial[t * H + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < H) {
    float a = red[0][lane];
#pragma unroll
    for (int k = 1; k < kSumWarps; ++k) a += red[k][lane];
    out[c] = a;
  }
}

template <typename T>
bool vector_rows(const void* X, int H) {
  return (static_cast<int64_t>(H) * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(X) % 16 == 0;
}

template <typename T>
int margins(const void* X, const void* w, const void* base, void* out,
            int64_t n, int H, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  hot_margins_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const float*>(w),
      static_cast<const float*>(base), static_cast<float*>(out), n, H,
      vector_rows<T>(X, H));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rmatvec(const void* X, const void* r, void* partial, void* out, int64_t n,
            int H, int64_t tiles, void* stream) {
  if (H <= 0) return 0;
  if (tiles != (n + kRowTile - 1) / kRowTile || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kGroup = 32 * Vec<T>::kN;
  const dim3 grid(static_cast<unsigned>(tiles), (H + kGroup - 1) / kGroup);
  hot_rmatvec_tiles_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(X), static_cast<const float*>(r),
      static_cast<float*>(partial), n, H, vector_rows<T>(X, H));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hot_rmatvec_sum_kernel<kWarps><<<(H + 31) / 32, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), tiles, H);
  return static_cast<int>(cudaGetLastError());
}

// -- The ring route (float32 rows of 16-byte vectors) -----------------------

constexpr int kRowGroup = kRowTile;  // rows a partial row covers
constexpr int kMaxRows = 8;          // tile rows: one warp a row (margins)
constexpr int kMaxStages = 8;
constexpr int kMaxColumns = 8192;
constexpr int kMaxShared = 232448;   // opt-in shared memory of a block
constexpr int kRegVecs = 4;          // w vectors a lane holds, H <= 512
constexpr int kRmatvecThreads = 128;
// float4 column vectors a thread owns in hot_rmatvec, at most.
constexpr int kMaxVec = kMaxColumns / (4 * kRmatvecThreads);

// Floats of the scratch beside the ring: w (margins), or the splits' sums
// at a group's end (rmatvec: at most 256 float4s).
__host__ __device__ constexpr int scratch_floats(int H) {
  return H > 4 * kThreads ? H : 4 * kThreads;
}

__host__ __device__ constexpr size_t ring_bytes(int H, int R, int S) {
  return static_cast<size_t>(S) * R * H * 4 + scratch_floats(H) * 4 +
         S * 8;
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

// The ring in dynamic shared memory: S slots of R rows of H floats, the
// scratch, then one mbarrier a slot.
struct Ring {
  float4* tiles;
  float* scratch;
  uint64_t* bars;
  int R, S, nvec;

  __device__ Ring(unsigned char* smem, int H, int rows, int stages)
      : R(rows), S(stages), nvec(H / 4) {
    tiles = reinterpret_cast<float4*>(smem);
    scratch = reinterpret_cast<float*>(tiles + static_cast<size_t>(S) * R *
                                                   nvec);
    bars = reinterpret_cast<uint64_t*>(scratch + scratch_floats(H));
  }

  __device__ const float4* slot(int s) const {
    return tiles + static_cast<size_t>(s) * R * nvec;
  }

  // Thread 0, once, before a __syncthreads.
  __device__ void init() const {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // Thread 0: rows [row0, row0 + rows) of X into slot s. The rows lie
  // back to back in X and in the slot, so one bulk copy moves them all.
  // ``reuse``: the slot was read since its last fill.
  __device__ void fill(int s, const float* X, int64_t row0, int rows,
                       bool reuse) const {
    const uint32_t bytes = static_cast<uint32_t>(rows) * nvec * 16;
    if (reuse) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(&bars[s], bytes);  // an empty tile completes at once
    if (rows > 0) {
      bulk_load(tiles + static_cast<size_t>(s) * R * nvec,
                X + row0 * static_cast<int64_t>(nvec) * 4, bytes, &bars[s]);
    }
  }

  // Fill number k of slot s has landed.
  __device__ void wait(int s, int64_t k) const {
    mbar_wait(&bars[s], static_cast<uint32_t>(k & 1));
  }
};

struct RingArgs {
  const float* X;
  const float* v;  // w (margins) or r (rmatvec)
  const float* base;
  float* out;  // (n,) margins, or the (groups, H) partials
  int64_t n;
  int64_t groups;
  int H;
  int rows;    // R
  int stages;  // S
};

// One warp a tile row: 32 R threads.
template <bool kWRegs>
__global__ void __launch_bounds__(kThreads, 1)
ring_margins_kernel(const RingArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring(smem, a.H, a.rows, a.stages);
  const int R = a.rows, S = a.stages, nvec = a.H / 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t P = gridDim.x;
  // This block's tiles: b, b + P, ...; only the last tile of all may be
  // short.
  const int64_t tiles = (a.n + R - 1) / R;
  const int64_t my_tiles = (tiles - b + P - 1) / P;
  auto row0_of = [&](int64_t k) { return (b + k * P) * R; };
  auto rows_of = [&](int64_t row0) {
    return static_cast<int>(a.n - row0 < R ? a.n - row0 : R);
  };

  for (int h = tid; h < a.H; h += blockDim.x) ring.scratch[h] = a.v[h];
  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0) {
    for (int64_t k = 0; k < S && k < my_tiles; ++k) {
      ring.fill(static_cast<int>(k), a.X, row0_of(k), rows_of(row0_of(k)),
                false);
    }
  }
  const float4* w_s = reinterpret_cast<const float4*>(ring.scratch);
  float4 w_r[kRegVecs];
  if (kWRegs) {
#pragma unroll
    for (int m = 0; m < kRegVecs; ++m) {
      const int j = lane + 32 * m;
      w_r[m] = j < nvec ? w_s[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // base[i] of this warp's row, loaded one tile ahead: its latency hides
  // behind a tile's wait.
  auto base_of = [&](int64_t k) {
    const int64_t row0 = row0_of(k);
    return warp < rows_of(row0) ? a.base[row0 + warp] : 0.f;
  };
  float b_next = base_of(0);
  for (int64_t k = 0; k < my_tiles; ++k) {
    const int s = static_cast<int>(k % S);
    const int64_t row0 = row0_of(k);
    const float bi = b_next;
    if (k + 1 < my_tiles) b_next = base_of(k + 1);
    ring.wait(s, k / S);
    if (warp < rows_of(row0)) {
      const float4* x = ring.slot(s) + static_cast<size_t>(warp) * nvec;
      float acc = 0.f;
      if (kWRegs) {
#pragma unroll
        for (int m = 0; m < kRegVecs; ++m) {
          const int j = lane + 32 * m;
          if (j < nvec) acc = dot4(x[j], w_r[m], acc);
        }
      } else {
        for (int j = lane; j < nvec; j += 32) acc = dot4(x[j], w_s[j], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) a.out[row0 + warp] = acc + bi;
    }
    __syncthreads();  // the slot is free again
    if (tid == 0 && k + S < my_tiles) {
      ring.fill(s, a.X, row0_of(k + S), rows_of(row0_of(k + S)), true);
    }
  }
}

// kVecs: the 16-byte column vectors a thread owns (1, 2, 4, 8 or 16).
// kSplits: the splits that share a tile's rows (1, 2, 4 or 8; more than
// one only with kVecs = 1). C = T / kSplits threads cover a row: thread c
// of split s owns the vectors c, c + C, ... and adds the tile rows
// q = s, s + kSplits, ... of each of its group's tiles in turn.
template <int kVecs, int kSplits>
__global__ void __launch_bounds__(kRmatvecThreads, kVecs == 1 ? 4 : 1)
ring_rmatvec_kernel(const RingArgs a) {
  constexpr int T = kRmatvecThreads;
  constexpr int C = T / kSplits;
  constexpr int kRowsPer = kMaxRows / kSplits;  // a split's tile rows
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring(smem, a.H, a.rows, a.stages);
  const int R = a.rows, S = a.stages, nvec = a.H / 4;
  const int tid = threadIdx.x;
  const int split = tid / C;
  const int c = tid % C;
  const int64_t b = blockIdx.x;
  const int64_t P = gridDim.x;
  const int64_t G = a.groups;
  // This block's tiles: the groups b, b + P, ..., kRowGroup / R tiles
  // each. Group g's tiles are the R-row tiles g, g + G, g + 2 G, ... of X,
  // so the blocks read neighbouring tiles at once; past n a tile is short
  // or empty.
  const int per_group = kRowGroup / R;
  const int64_t my_tiles = (G - b + P - 1) / P * per_group;
  auto row0_of = [&](int64_t t) {
    const int64_t k = t / per_group;
    return (b + k * P + (t - k * per_group) * G) * R;
  };
  auto rows_of = [&](int64_t row0) {
    const int64_t left = a.n - row0;
    return static_cast<int>(left < 0 ? 0 : left < R ? left : R);
  };

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0) {
    for (int64_t t = 0; t < S && t < my_tiles; ++t) {
      ring.fill(static_cast<int>(t), a.X, row0_of(t), rows_of(row0_of(t)),
                false);
    }
  }

  float4 acc[kVecs];
#pragma unroll
  for (int m = 0; m < kVecs; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  // r of this split's rows of tile t, loaded one tile ahead: their
  // latency hides behind a tile's wait.
  float r_next[kRowsPer];
  auto load_r = [&](int64_t t) {
    const int64_t row0 = row0_of(t);
    const int rows = rows_of(row0);
#pragma unroll
    for (int u = 0; u < kRowsPer; ++u) {
      const int q = split + u * kSplits;
      r_next[u] = q < rows ? a.v[row0 + q] : 0.f;
    }
  };
  load_r(0);
  for (int64_t t = 0; t < my_tiles; ++t) {
    const int s = static_cast<int>(t % S);
    const int rows = rows_of(row0_of(t));
    float r_q[kRowsPer];
#pragma unroll
    for (int u = 0; u < kRowsPer; ++u) r_q[u] = r_next[u];
    if (t + 1 < my_tiles) load_r(t + 1);
    ring.wait(s, t / S);
    const float4* tile = ring.slot(s);
#pragma unroll
    for (int u = 0; u < kRowsPer; ++u) {
      const int q = split + u * kSplits;
      if (q < rows) {
        const float4* x = tile + static_cast<size_t>(q) * nvec;
        const float rq = r_q[u];
#pragma unroll
        for (int m = 0; m < kVecs; ++m) {
          const int j = c + m * C;
          if (j < nvec) {
            const float4 xj = x[j];
            acc[m].x = fmaf(xj.x, rq, acc[m].x);
            acc[m].y = fmaf(xj.y, rq, acc[m].y);
            acc[m].z = fmaf(xj.z, rq, acc[m].z);
            acc[m].w = fmaf(xj.w, rq, acc[m].w);
          }
        }
      }
    }
    __syncthreads();  // the slot is free again
    if (tid == 0 && t + S < my_tiles) {
      ring.fill(s, a.X, row0_of(t + S), rows_of(row0_of(t + S)), true);
    }
    const int64_t g = t / per_group;
    if (t - g * per_group == per_group - 1 || t == my_tiles - 1) {
      // The group's partial row: the splits' sums in split order.
      float4* out = reinterpret_cast<float4*>(
          a.out + (b + g * P) * static_cast<int64_t>(a.H));
      if (kSplits > 1) {
        float4* red = reinterpret_cast<float4*>(ring.scratch);
        if (split > 0) red[(split - 1) * C + c] = acc[0];
        __syncthreads();
        if (split == 0 && c < nvec) {
          float4 sum = acc[0];
#pragma unroll
          for (int p = 1; p < kSplits; ++p) {
            const float4 o = red[(p - 1) * C + c];
            sum.x += o.x;
            sum.y += o.y;
            sum.z += o.z;
            sum.w += o.w;
          }
          out[c] = sum;
        }
      } else {
#pragma unroll
        for (int m = 0; m < kVecs; ++m) {
          const int j = c + m * C;
          if (j < nvec) out[j] = acc[m];
        }
      }
#pragma unroll
      for (int m = 0; m < kVecs; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The ring's checks: a block the route takes (float32 rows of 16-byte
// vectors from a 16-byte aligned base, 4 to kMaxColumns columns, n >= 1)
// and a geometry that fits, with the wrapper's count of its shared bytes.
bool ring_ok(const void* X, int64_t n, int H, int rows, int stages,
             long long bytes) {
  return n >= 1 && H >= 4 && H % 4 == 0 && H <= kMaxColumns &&
         aligned16(X) && rows >= 1 &&
         rows <= kMaxRows && kRowGroup % rows == 0 && stages >= 2 &&
         stages <= kMaxStages && ring_bytes(H, rows, stages) <= kMaxShared &&
         static_cast<size_t>(bytes) == ring_bytes(H, rows, stages);
}

// The blocks of one ring kernel the card holds at once, by (device,
// dynamic shared bytes): asked of the runtime once for each, since a
// streamed fit launches the kernel thousands of times.
struct Resident {
  std::mutex mu;
  std::unordered_map<int64_t, int64_t> blocks;
};

// The persistent grid: at most the blocks the card holds at once, and no
// more than ``work`` (tiles or groups). ``attr`` is the caller's one
// cudaFuncSetAttribute of the opt-in shared memory for ``kernel``, and
// ``resident`` its own cache.
int ring_grid(void (*kernel)(RingArgs), cudaError_t attr, Resident& resident,
              int threads, size_t bytes, int64_t work, int64_t* grid) {
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t key = (static_cast<int64_t>(device) << 32) |
                      static_cast<int64_t>(bytes);
  int64_t blocks = 0;
  {
    std::lock_guard<std::mutex> lock(resident.mu);
    const auto it = resident.blocks.find(key);
    if (it != resident.blocks.end()) blocks = it->second;
  }
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, bytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = static_cast<int64_t>(sms) * per_sm;
    std::lock_guard<std::mutex> lock(resident.mu);
    resident.blocks[key] = blocks;
  }
  *grid = work < blocks ? work : blocks;
  return 0;
}

template <bool kWRegs>
int ring_margins_launch(const RingArgs& a, size_t bytes, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_margins_kernel<kWRegs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  static Resident resident;
  int64_t grid = 0;
  const int threads = 32 * a.rows;
  const int err = ring_grid(ring_margins_kernel<kWRegs>, attr, resident,
                            threads, bytes, (a.n + a.rows - 1) / a.rows,
                            &grid);
  if (err != 0) return err;
  ring_margins_kernel<kWRegs>
      <<<static_cast<unsigned>(grid), threads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int ring_margins(const void* X, const void* w, const void* base, void* out,
                 int64_t n, int H, int rows, int stages, long long bytes,
                 void* stream) {
  if (!ring_ok(X, n, H, rows, stages, bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a{static_cast<const float*>(X), static_cast<const float*>(w),
             static_cast<const float*>(base), static_cast<float*>(out), n,
             0, H, rows, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H <= 4 * 32 * kRegVecs ? ring_margins_launch<true>(a, bytes, s)
                                : ring_margins_launch<false>(a, bytes, s);
}

template <int kVecs, int kSplits>
int ring_rmatvec_launch(const RingArgs& a, size_t bytes, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_rmatvec_kernel<kVecs, kSplits>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  static Resident resident;
  int64_t grid = 0;
  const int err = ring_grid(ring_rmatvec_kernel<kVecs, kSplits>, attr,
                            resident, kRmatvecThreads, bytes, a.groups,
                            &grid);
  if (err != 0) return err;
  ring_rmatvec_kernel<kVecs, kSplits>
      <<<static_cast<unsigned>(grid), kRmatvecThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The splits of a tile's rows at width H with R-row tiles: the most (a
// power of two up to 8, at most R) whose share of the block still covers
// a row's 16-byte vectors, one a thread.
int row_splits(int H, int R) {
  int splits = 1;
  while (splits < kMaxRows && 2 * splits <= R &&
         kRmatvecThreads / (2 * splits) >= H / 4) {
    splits *= 2;
  }
  return splits;
}

int ring_rmatvec(const void* X, const void* r, void* partial, void* out,
                 int64_t n, int H, int rows, int stages, long long bytes,
                 int64_t groups, void* stream) {
  if (!ring_ok(X, n, H, rows, stages, bytes) ||
      groups != (n + kRowGroup - 1) / kRowGroup || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a{static_cast<const float*>(X), static_cast<const float*>(r),
             nullptr, static_cast<float*>(partial), n, groups, H, rows,
             stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The column vectors a thread owns, rounded up to a power of two, and
  // the splits of a tile's rows.
  const int per_thread = (H / 4 + kRmatvecThreads - 1) / kRmatvecThreads;
  int e = 0;
  if (per_thread <= 1) {
    switch (row_splits(H, rows)) {
      case 8: e = ring_rmatvec_launch<1, 8>(a, bytes, s); break;
      case 4: e = ring_rmatvec_launch<1, 4>(a, bytes, s); break;
      case 2: e = ring_rmatvec_launch<1, 2>(a, bytes, s); break;
      default: e = ring_rmatvec_launch<1, 1>(a, bytes, s);
    }
  } else {
    e = per_thread <= 2   ? ring_rmatvec_launch<2, 1>(a, bytes, s)
        : per_thread <= 4 ? ring_rmatvec_launch<4, 1>(a, bytes, s)
        : per_thread <= 8 ? ring_rmatvec_launch<8, 1>(a, bytes, s)
                          : ring_rmatvec_launch<kMaxVec, 1>(a, bytes, s);
  }
  if (e != 0) return e;
  hot_rmatvec_sum_kernel<32><<<(H + 31) / 32, 32 * 32, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), groups,
      H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (n,) = base + X @ w. X (n, H) contiguous; w (H,), base (n,) float32.
int hot_margins_i8(const void* X, const void* w, const void* base, void* out,
                   long long n, int H, void* stream) {
  return margins<int8_t>(X, w, base, out, n, H, stream);
}
int hot_margins_bf16(const void* X, const void* w, const void* base,
                     void* out, long long n, int H, void* stream) {
  return margins<uint16_t>(X, w, base, out, n, H, stream);
}
int hot_margins_f32(const void* X, const void* w, const void* base, void* out,
                    long long n, int H, void* stream) {
  return margins<float>(X, w, base, out, n, H, stream);
}

// out (H,) = X^T r. partial is a (tiles, H) float32 scratch with
// tiles = ceil(n / 512), n >= 1.
int hot_rmatvec_i8(const void* X, const void* r, void* partial, void* out,
                   long long n, int H, long long tiles, void* stream) {
  return rmatvec<int8_t>(X, r, partial, out, n, H, tiles, stream);
}
int hot_rmatvec_bf16(const void* X, const void* r, void* partial, void* out,
                     long long n, int H, long long tiles, void* stream) {
  return rmatvec<uint16_t>(X, r, partial, out, n, H, tiles, stream);
}
int hot_rmatvec_f32(const void* X, const void* r, void* partial, void* out,
                    long long n, int H, long long tiles, void* stream) {
  return rmatvec<float>(X, r, partial, out, n, H, tiles, stream);
}

// The ring route (see the note above): X (n, H) float32, contiguous, its
// base on 16 bytes, H a multiple of 4 from 4 to 8,192, n >= 1. rows (R,
// 1..8, dividing 512) and stages (S, 2..8) are the ring's geometry and
// bytes its dynamic shared memory, S * R * H * 4 + max(H, 1024) * 4 +
// S * 8, which must fit a block. Any other block or geometry returns
// cudaErrorInvalidValue.
int hot_margins_f32_ring(const void* X, const void* w, const void* base,
                         void* out, long long n, int H, int rows, int stages,
                         long long bytes, void* stream) {
  return ring_margins(X, w, base, out, n, H, rows, stages, bytes, stream);
}
// partial is a (groups, H) float32 scratch on 16 bytes, groups =
// ceil(n / 512).
int hot_rmatvec_f32_ring(const void* X, const void* r, void* partial,
                         void* out, long long n, int H, int rows, int stages,
                         long long bytes, long long groups, void* stream) {
  return ring_rmatvec(X, r, partial, out, n, H, rows, stages, bytes, groups,
                      stream);
}

}  // extern "C"
