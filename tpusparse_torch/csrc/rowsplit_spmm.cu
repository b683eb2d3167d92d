// K4 — row-split CSR SpMM for Hopper (sm_90a): Y (num_rows, L) = A X for
// X (num_cols, L), both row-major float32; and K4d, its float64 twin.
//
// K4 replaces the Pallas TPU kernel tpusparse/kernels/ell_spmm.py::
// _spmm_ell (body _ell_kernel), the row-splitting strategy of the
// reference (OmpCsrSpmmT: one worker per row, SIMD over the RHS lanes).
// K4d replaces tpusparse/kernels/ell_df.py::_spmm_ell_df (body
// _ell_df_kernel), the same product in double-float (two-f32) arithmetic
// because Mosaic has no 64-bit types; here it is the same template at
// IEEE float64.
//
// Bound: bytes. Per nonzero 8 B of column index and value (12 B in
// float64) read once, and 4 L B of X gathered (8 L B), coalesced across
// a row's thread group and cached when columns cluster; per row 4 L B of
// Y (8 L B) written once.
//
// Design: a row split over work rows, with long rows cut. The plan
// (kernels/ell_spmm.py, built on the host) cuts every row longer than C
// (ROW_CHUNK) nonzeros into chunks of C; each whole row and each chunk is
// a work row:
//
//   * multiply: one group of W = min(32, next_pow2(L)) threads per work
//     row, one RHS lane per thread (lane chunks of 32 for L > 32 walk the
//     row again), walks it in CSR order. A group loads the column indices
//     and values of kUnroll entries, then their X rows, then adds them,
//     so kUnroll X loads are in flight at once; the last len mod kUnroll
//     entries go one at a time;
//   * writes: a whole row writes Y[row, l] once; a chunk writes its
//     partial to a (chunks, L) workspace the wrapper allocates;
//   * fix-up: a second kernel, launched only when the plan has split
//     rows, sums each (split row, lane)'s partials in chunk order into Y,
//     their loads independent and in flight together.
//
// A hub row thus runs as ceil(len / C) chains of at most C entries on as
// many groups instead of one chain of len entries on one group. A form
// that staged CSR-Adaptive row blocks (Greathouse and Daga, SC'14) in
// shared memory with cp.async was 13 % slower over rmat-18-ef16 and
// lap3d-160 in both types, and a body that predicates its last batch
// instead of finishing one entry at a time 6 % (PERF.md §6). The TPU
// kernel's gather-job tiles (formats/ell.py, 128-lane job packing), its
// (L, 128) register blocks and its VMEM-resident RHS (and the size
// refusal that goes with it) have no counterpart.
//
// Numerical contract: a row of length <= C is summed in one pass in CSR
// order; a split row is each chunk summed in CSR order, then the partials
// in chunk order. Products and sums round separately (no FMA
// contraction, rn_arith.cuh) and no float atomics are used, so two runs
// give bitwise equal Y, equal to the plain version (which follows the
// same order) run on the CPU. Every row stays within (nnz_i + 2) u
// (|A||X|)_i of the exact product: a split row's error constant is at
// most C + ceil(nnz_i / C) <= nnz_i + 2. Index arithmetic on X, Y and
// the partials is 64-bit.

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLaneWidth = 32;
constexpr int kUnroll = 4;       // X loads a group has in flight
constexpr int kFixUnroll = 8;    // partial loads in flight in the fix-up

// One lane of a work row: the sum over entries [b, e), in order, of
// values[j] * X[col_indices[j], l] (x = X + l), kUnroll entries at a
// time, the rest one by one.
template <typename T>
__device__ __forceinline__ T row_sum(const int* __restrict__ col_indices,
                                     const T* __restrict__ values, int b,
                                     int e, const T* __restrict__ x, int L) {
  T acc = T(0);
  int j = b;
  for (; j + kUnroll <= e; j += kUnroll) {
    int c[kUnroll];
    T v[kUnroll];
    T xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c[u] = __ldg(col_indices + j + u);
      v[u] = __ldg(values + j + u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = __ldg(x + static_cast<long long>(c[u]) * L);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = tps_rn::add(acc, tps_rn::mul(v[u], xv[u]));
    }
  }
  for (; j < e; ++j) {
    const T xv = __ldg(x + static_cast<long long>(__ldg(col_indices + j)) * L);
    acc = tps_rn::add(acc, tps_rn::mul(__ldg(values + j), xv));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsplit_spmm_kernel(const int* __restrict__ work_offsets,
                     const int* __restrict__ work_dest,
                     const int* __restrict__ col_indices,
                     const T* __restrict__ values, const T* __restrict__ X,
                     T* __restrict__ Y, T* __restrict__ partials,
                     int num_work, int L, int log2w) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> log2w;
  if (w >= num_work) return;
  const int lane = threadIdx.x & ((1 << log2w) - 1);
  const int b = work_offsets[w];
  const int e = work_offsets[w + 1];
  const int d = work_dest[w];
  T* out = d >= 0 ? Y + static_cast<long long>(d) * L
                  : partials + static_cast<long long>(~d) * L;
  for (int l = lane; l < L; l += kMaxLaneWidth) {
    out[l] = row_sum(col_indices, values, b, e, X + l, L);
  }
}

// Y[split_rows[k], l] = the partials of split row k, lane l, summed in
// chunk order; one thread per (split row, lane).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsplit_fixup_kernel(const int* __restrict__ split_rows,
                      const int* __restrict__ split_offsets,
                      const T* __restrict__ partials, T* __restrict__ Y,
                      long long items, int L) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= items) return;
  const int k = static_cast<int>(t / L);
  const int l = static_cast<int>(t - static_cast<long long>(k) * L);
  const int s0 = split_offsets[k];
  const int s1 = split_offsets[k + 1];
  const T* p = partials + l;
  T acc = T(0);
  for (int s = s0; s < s1; s += kFixUnroll) {
    T v[kFixUnroll];
#pragma unroll
    for (int u = 0; u < kFixUnroll; ++u) {
      v[u] = s + u < s1 ? p[static_cast<long long>(s + u) * L] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kFixUnroll; ++u) {
      if (s + u < s1) acc = tps_rn::add(acc, v[u]);
    }
  }
  Y[static_cast<long long>(split_rows[k]) * L + l] = acc;
}

template <typename T>
int run(const void* work_offsets, const void* work_dest,
        const void* col_indices, const void* values, const void* X, void* Y,
        void* partials, const void* split_rows, const void* split_offsets,
        int num_work, int num_split, int L, void* stream) {
  if (num_work < 0 || num_split < 0 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_work == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log2w = 0;
  while ((1 << log2w) < L && (1 << log2w) < kMaxLaneWidth) ++log2w;
  const long long threads = static_cast<long long>(num_work) << log2w;
  rowsplit_spmm_kernel<T>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
         kThreads, 0, s>>>(
          static_cast<const int*>(work_offsets),
          static_cast<const int*>(work_dest),
          static_cast<const int*>(col_indices),
          static_cast<const T*>(values), static_cast<const T*>(X),
          static_cast<T*>(Y), static_cast<T*>(partials), num_work, L, log2w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_split == 0) return static_cast<int>(err);
  const long long items = static_cast<long long>(num_split) * L;
  rowsplit_fixup_kernel<T>
      <<<static_cast<unsigned>((items + kThreads - 1) / kThreads), kThreads,
         0, s>>>(static_cast<const int*>(split_rows),
                 static_cast<const int*>(split_offsets),
                 static_cast<const T*>(partials), static_cast<T*>(Y), items,
                 L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (num_rows, L) = A @ X (num_cols, L), row-major float32 (K4), for the
// CSR (col_indices, values) under its work-row table (work_offsets,
// work_dest, split_rows, split_offsets; kernels/ell_spmm.py); partials
// is the (chunks, L) workspace of the split rows. Launches the work-row
// kernel and, when num_split > 0, the fix-up. Returns the
// cudaGetLastError() code after the launches.
extern "C" int tps_rowsplit_spmm(const void* work_offsets,
                                 const void* work_dest,
                                 const void* col_indices, const void* values,
                                 const void* X, void* Y, void* partials,
                                 const void* split_rows,
                                 const void* split_offsets, int num_work,
                                 int num_split, int L, void* stream) {
  return run<float>(work_offsets, work_dest, col_indices, values, X, Y,
                    partials, split_rows, split_offsets, num_work, num_split,
                    L, stream);
}

// The same in float64 (K4d): values, X, Y and partials are double.
extern "C" int tps_rowsplit_spmm_f64(const void* work_offsets,
                                     const void* work_dest,
                                     const void* col_indices,
                                     const void* values, const void* X,
                                     void* Y, void* partials,
                                     const void* split_rows,
                                     const void* split_offsets, int num_work,
                                     int num_split, int L, void* stream) {
  return run<double>(work_offsets, work_dest, col_indices, values, X, Y,
                     partials, split_rows, split_offsets, num_work,
                     num_split, L, stream);
}
