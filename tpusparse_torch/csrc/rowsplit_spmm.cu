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
// Here a row's worker is a group of W threads, W = the next power of two
// >= L and at most 32, one RHS lane per thread; a warp holds 32 / W rows.
// Each thread walks its row's nonzeros in CSR order and writes Y[row, l]
// once; for L > 32 it loops over chunks of 32 lanes. No atomics and a
// fixed summation order: two runs give bitwise equal Y. Products and sums
// round separately (no FMA contraction, rn_arith.cuh), as in the plain
// version.
//
// The TPU kernel's gather-job tiles (formats/ell.py, 128-lane job
// packing), its (L, 128) register blocks and its VMEM-resident RHS (and
// the size refusal that goes with it) have no counterpart: the operand
// is the CSR itself, and X is read through the cache.
//
// Bound: bytes. Per nonzero 8 B of column index and value (12 B in
// float64; read once per row by the whole group: the W threads load one
// address) and 4 L B of X gathered (8 L B), coalesced across the group
// (cached when columns cluster); per row 4 L B of Y (8 L B). Work per group is the row's length, so a long row
// (a wheel hub) runs serially on one group: right, and slow. Index
// arithmetic on X and Y is 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLaneWidth = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsplit_spmm_kernel(const int* __restrict__ row_offsets,
                     const int* __restrict__ col_indices,
                     const T* __restrict__ values, const T* __restrict__ X,
                     T* __restrict__ Y, int num_rows, int L, int log2w) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> log2w;
  if (row >= num_rows) return;
  const int lane = threadIdx.x & ((1 << log2w) - 1);
  const int begin = row_offsets[row];
  const int end = row_offsets[row + 1];
  for (int l = lane; l < L; l += kMaxLaneWidth) {
    T acc = T(0);
    for (int j = begin; j < end; ++j) {
      const T xv =
          __ldg(X + static_cast<long long>(__ldg(col_indices + j)) * L + l);
      acc = tps_rn::add(acc, tps_rn::mul(__ldg(values + j), xv));
    }
    Y[row * L + l] = acc;
  }
}

template <typename T>
int run(const void* row_offsets, const void* col_indices, const void* values,
        const void* X, void* Y, int num_rows, int L, void* stream) {
  if (num_rows < 0 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows == 0) return 0;
  int log2w = 0;
  while ((1 << log2w) < L && (1 << log2w) < kMaxLaneWidth) ++log2w;
  const long long threads = static_cast<long long>(num_rows) << log2w;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  rowsplit_spmm_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_offsets),
      static_cast<const int*>(col_indices), static_cast<const T*>(values),
      static_cast<const T*>(X), static_cast<T*>(Y), num_rows, L, log2w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (num_rows, L) = A @ X (num_cols, L) for CSR (row_offsets,
// col_indices, values), row-major float32 (K4). Returns the
// cudaGetLastError() code after the launch.
extern "C" int tps_rowsplit_spmm(const void* row_offsets,
                                 const void* col_indices, const void* values,
                                 const void* X, void* Y, int num_rows, int L,
                                 void* stream) {
  return run<float>(row_offsets, col_indices, values, X, Y, num_rows, L,
                    stream);
}

// The same in float64 (K4d): values, X and Y are double.
extern "C" int tps_rowsplit_spmm_f64(const void* row_offsets,
                                     const void* col_indices,
                                     const void* values, const void* X,
                                     void* Y, int num_rows, int L,
                                     void* stream) {
  return run<double>(row_offsets, col_indices, values, X, Y, num_rows, L,
                     stream);
}
