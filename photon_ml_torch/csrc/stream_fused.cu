// stream_fused: the hot tier of a row-streamed sparse chunk, for NVIDIA
// Hopper (sm_90a). Two kernels over the chunk's dense hot block X (n, H),
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
// (n = 262,144, H = 512, int8) margins moves about 136.3 MB (40.7 us) and
// rmatvec about 135.3 MB (40.4 us); at float32 about four times that.
//
// hot_margins design. One warp per row, 8 warps and 64 rows a block. w is
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
// hot_rmatvec design. The rows are cut into tiles of kRowTile = 512; the
// columns into groups of 32 * V (one 16-byte vector a lane). Pass 1: one
// block per (row tile, column group). Warp w adds rows w, w + 8, ... of
// the tile into V float32 sums a lane (fmaf, in row order); the 8 warp
// sums of each column are then added in warp order through shared memory
// and written to partial[tile, column]. Pass 2: one block per 32 columns;
// warp w adds the tiles w, w + 8, ... in order, and lane 0..31 of warp 0
// adds the 8 warp sums in order. At the streamed chunk pass 1 runs 512
// blocks where one block per column tile would run one. No atomics: the
// order is fixed by the shapes, so two launches give the same bits.
//
// Offsets: n is int64 and every element offset is formed in int64
// (n * H passes 2^31 at a larger chunk_rows). The wrapper allocates out
// and the (tiles, H) partials.
//
// Plain C interface for ctypes: each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
hot_rmatvec_sum_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int64_t tiles, int H) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < H) {
    for (int64_t t = warp; t < tiles; t += kWarps) s += partial[t * H + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < H) {
    float a = red[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) a += red[k][lane];
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
  hot_rmatvec_sum_kernel<<<(H + 31) / 32, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), tiles, H);
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

}  // extern "C"
