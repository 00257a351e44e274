// ell_scatter: the ELL scatter-add of the sparse GLM objective, for NVIDIA
// Hopper (sm_90a), in two forms that share one summation order.
//
//   out[c] = sum over slots (i, k) with indices[i, k] == c of t[i, k],
//            for 0 <= c < dim; padding slots (id >= dim) add nothing.
//
//   ell_scatter: t = rv, row terms the caller formed (n, k).
//   ell_rmatvec: t[i, k] = r[i] * values[i, k], or r[i] * values[i, k]^2,
//                formed here from r (n,): X^T r over the ELL pattern.
//
// It is the gradient, H.v and Hessian-diagonal reduction of the sparse
// (ELL) objective; the ELL objective calls ell_rmatvec, the hybrid
// layout's cold margins and the streamed chunks' cold tier ell_scatter.
// Replaces the TPU kernel photon_ml_tpu/ops/kernels/ell_scatter.py
// scatter_rowterm_pallas (pl.pallas_call at :90, body _kernel at :34),
// whose plain XLA version is scatter_rowterm_xla. The Pallas program walks
// a (column tile x row tile) grid and, per cell, compares every slot id
// with 128 column ids: O(d*nnz) compares, cheap on the TPU's vector unit
// only while d stays near a few thousand. It is not carried over.
//
// Layout. The ELL pattern is fixed for a whole fit, so the wrapper
// (photon_ml_torch/ops/kernels/ell_scatter.py build_layout) sorts the flat
// ids once per staged batch, stably, into a column order of the valid
// slots with a column pointer col_ptr (dim + 1). For ell_scatter it keeps
// perm, each entry's flat slot; for ell_rmatvec each entry's row and value
// in column order (rows, sorted_values) and no perm.
//
// Order. Every call is a segmented sum in a fixed order, with no atomics:
//   pass 1 (piece_sums): columns of more than 32 entries are cut into
//     pieces of at most 4096 entries. One warp per piece: lane l adds
//     entries l, l + 32, l + 64, ... in order, then a __shfl_xor_sync
//     butterfly (16, 8, 4, 2, 1) adds the 32 lane sums; a commutative pair
//     per step, so every lane ends with the same bits. Lane 0 writes the
//     piece's partial.
//   pass 2 (column_sums): one thread per column. A column with pieces adds
//     its partials in order; a column of at most 32 entries adds them in
//     row order; an empty column writes 0.
// The two forms run the same two passes (one template, a term policy
// each), and ell_rmatvec forms each term as __fmul_rn(r[row], v) or
// __fmul_rn(r[row], __fmul_rn(v, v)): one rounding, as the caller's
// r[:, None] * values (values * values) has, and no multiply-add
// contraction into the sum. So ell_rmatvec gives the same bits as
// ell_scatter over the materialised row terms, and two launches give the
// same bits.
//
// This answers the Zipf head of config 5 (d = 1,000,000, Zipf(1.3)
// columns): its hottest column holds an entry in nearly every row (about
// 10M at full size) while most columns hold 0-2. A thread per column alone
// would run a 10M-long chain of adds; here that column is ~2,400 warps of
// work in pass 1 and a 2,400-term sum in pass 2.
//
// Bound on the H100 (3.35 TB/s): bytes (one multiply and one add a slot).
// ell_rmatvec reads each valid slot's id and value once (8 bytes), r once
// (4 n) and writes dim floats: at config 5's n = 9.5M, k = 32, dim = 1M,
// with 183M valid slots (Zipf draws that repeat within a row are padding),
// 1.51 GB, 0.450 ms. ell_scatter's own function reads the ids and row
// terms of all n * k slots (8 bytes a slot) and writes dim floats: 2.44
// GB, 0.727 ms.
//
// Why ell_rmatvec. ell_scatter reads perm sequentially but gathers
// rv[perm[j]]: within a column the entries are in row order, so
// consecutive entries lie k slots (128 bytes at k = 32) apart in rv, and
// each load takes a 32-byte sector for 4 useful bytes. Its caller also
// wrote and read the (n, k) rv temporary (1.2 GB) every call. ell_rmatvec
// reads rows and sorted_values sequentially (__ldcs, evict-first, so the
// stream does not push r out of L2) and gathers r[row] (__ldg): in the
// Zipf head consecutive entries are consecutive rows, so those gathers
// coalesce, and r (38 MB at 9.5M rows) fits in the 50 MB L2. At the main
// shape chip_smoke.py times ell_rmatvec at 1.47 ms (31% of its bound)
// against 6.57 ms for the old route (the multiply, then ell_scatter at
// 5.56 ms), on an NVIDIA H100 80GB HBM3 at 700 W.
//
// What holds it back now: the gathers of r in column order. About half
// the valid slots lie in columns whose rows are more than 8 apart, so each
// of those gathers takes its own 32-byte L2 sector for 4 useful bytes.
// The same gathers alone, one r.index_select at the layout's rows, take
// 1.74 ms in chip_smoke.py, longer than this kernel's whole call. Fewer
// sectors need a row-blocked order of the sums, which would change their
// bits.
//
// Loads. In pass 1 the warp's lanes read 32 neighbouring entries per
// step, so each 4-byte load instruction of rows, values or perm is one
// full 128-byte line; a lane issues four steps' loads, then their
// gathers, then its four adds in order. A 16-byte load per lane would hand
// a lane four neighbouring entries, which belong to four lanes in the
// fixed order, so pass 1 keeps 4-byte loads. In pass 2 a thread adds its
// short column's entries one after another, so ell_rmatvec reads the part
// of the segment that lies on 16-byte boundaries with int4/float4 loads
// (where both arrays start on 16 bytes) and the ends with 4-byte loads:
// the order is fixed by the column's length alone, whatever the width.
//
// Offsets: perm entries, rows, col_ptr and the piece bounds are int32 (the
// wrapper refuses more than 2^31 - 1 slots); loop counters are int64 and
// every pointer offset is formed in int64. No shared memory; the wrapper
// allocates out and the partials.
//
// Plain C interface for ctypes: the launchers return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
// Steps of 32 entries a lane loads before it adds (pass 1).
constexpr int kSteps = 4;

// ell_scatter's term of entry j: the caller's row term at slot perm[j].
struct GatheredTerm {
  const float* __restrict__ rv;
  const int32_t* __restrict__ perm;

  // The terms of entries j, j + 32, ..., U of them: loads, then gathers.
  template <int U>
  __device__ __forceinline__ void strided(int64_t j, float (&t)[U]) const {
    int32_t slot[U];
#pragma unroll
    for (int u = 0; u < U; ++u) slot[u] = __ldcs(perm + j + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u) t[u] = rv[static_cast<int64_t>(slot[u])];
  }

  // The in-order sum of entries [lo, hi).
  __device__ __forceinline__ float run(int64_t lo, int64_t hi) const {
    float acc = 0.0f;
    for (int64_t j = lo; j < hi; ++j) {
      acc += rv[static_cast<int64_t>(perm[j])];
    }
    return acc;
  }
};

// ell_rmatvec's term of entry j: r[rows[j]] * v (v^2 under kSquare), one
// rounding, never contracted into the add that takes it.
template <bool kSquare>
struct FormedTerm {
  const float* __restrict__ r;
  const int32_t* __restrict__ rows;
  const float* __restrict__ vals;
  bool vec;  // rows and vals both start on 16 bytes

  __device__ __forceinline__ static float term(float g, float v) {
    return kSquare ? __fmul_rn(g, __fmul_rn(v, v)) : __fmul_rn(g, v);
  }

  __device__ __forceinline__ float one(int64_t j) const {
    return term(__ldg(r + __ldcs(rows + j)), __ldcs(vals + j));
  }

  template <int U>
  __device__ __forceinline__ void strided(int64_t j, float (&t)[U]) const {
    int32_t row[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = __ldcs(rows + j + 32 * u);
      v[u] = __ldcs(vals + j + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) t[u] = term(__ldg(r + row[u]), v[u]);
  }

  __device__ __forceinline__ float run(int64_t lo, int64_t hi) const {
    float acc = 0.0f;
    int64_t j = lo;
    if (vec) {
      for (; j < hi && (j & 3) != 0; ++j) acc += one(j);
      for (; j + 4 <= hi; j += 4) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(rows + j));
        const float4 b = __ldcs(reinterpret_cast<const float4*>(vals + j));
        const float g0 = __ldg(r + a.x), g1 = __ldg(r + a.y);
        const float g2 = __ldg(r + a.z), g3 = __ldg(r + a.w);
        acc += term(g0, b.x);
        acc += term(g1, b.y);
        acc += term(g2, b.z);
        acc += term(g3, b.w);
      }
    }
    for (; j < hi; ++j) acc += one(j);
    return acc;
  }
};

template <class Term>
__global__ void __launch_bounds__(kThreads)
piece_sums_kernel(const Term term, const int32_t* __restrict__ piece_start,
                  const int32_t* __restrict__ piece_end,
                  float* __restrict__ partial, int num_pieces) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (p >= num_pieces) return;  // the whole warp leaves together
  const int64_t hi = piece_end[p];
  float acc = 0.0f;
  int64_t j = static_cast<int64_t>(piece_start[p]) + lane;
  for (; j + 32 * (kSteps - 1) < hi; j += 32 * kSteps) {
    float t[kSteps];
    term.template strided<kSteps>(j, t);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) acc += t[u];
  }
  for (; j < hi; j += 32) {
    float t[1];
    term.template strided<1>(j, t);
    acc += t[0];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) partial[p] = acc;
}

template <class Term>
__global__ void __launch_bounds__(kThreads)
column_sums_kernel(const Term term, const int32_t* __restrict__ col_ptr,
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
    acc = term.run(col_ptr[c], col_ptr[c + 1]);
  }
  out[c] = acc;
}

template <class Term>
int segmented_sums(const Term& term, const void* col_ptr,
                   const void* piece_ptr, const void* piece_start,
                   const void* piece_end, void* partial, void* out, int dim,
                   int num_pieces, void* stream) {
  if (dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (num_pieces > 0) {
    const int64_t blocks =
        (static_cast<int64_t>(num_pieces) + kWarpsPerBlock - 1) /
        kWarpsPerBlock;
    piece_sums_kernel<Term><<<static_cast<unsigned>(blocks), kThreads, 0,
                              s>>>(
        term, static_cast<const int32_t*>(piece_start),
        static_cast<const int32_t*>(piece_end), part, num_pieces);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (static_cast<int64_t>(dim) + kThreads - 1) /
                         kThreads;
  column_sums_kernel<Term><<<static_cast<unsigned>(blocks), kThreads, 0,
                             s>>>(
      term, static_cast<const int32_t*>(col_ptr),
      static_cast<const int32_t*>(piece_ptr), part,
      static_cast<float*>(out), dim);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  const GatheredTerm term{static_cast<const float*>(rv),
                          static_cast<const int32_t*>(perm)};
  return segmented_sums(term, col_ptr, piece_ptr, piece_start, piece_end,
                        partial, out, dim, num_pieces, stream);
}

// out (dim,) = per-column sums of r[rows[j]] * vals[j] (vals[j]^2 when
// square != 0) over the layout; r is (n,), rows and vals the layout's
// (nnz,) column-ordered rows and values, the rest as for ell_scatter.
int ell_rmatvec(const void* r, const void* rows, const void* vals,
                const void* col_ptr, const void* piece_ptr,
                const void* piece_start, const void* piece_end,
                void* partial, void* out, int dim, int num_pieces,
                int square, void* stream) {
  const float* rp = static_cast<const float*>(r);
  const int32_t* rw = static_cast<const int32_t*>(rows);
  const float* vp = static_cast<const float*>(vals);
  const bool vec = aligned16(rows) && aligned16(vals);
  if (square != 0) {
    const FormedTerm<true> term{rp, rw, vp, vec};
    return segmented_sums(term, col_ptr, piece_ptr, piece_start, piece_end,
                          partial, out, dim, num_pieces, stream);
  }
  const FormedTerm<false> term{rp, rw, vp, vec};
  return segmented_sums(term, col_ptr, piece_ptr, piece_start, piece_end,
                        partial, out, dim, num_pieces, stream);
}

}  // extern "C"
