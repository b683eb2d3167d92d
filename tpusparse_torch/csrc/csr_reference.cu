// KR — the reference CSR product on the card (sm_90a), and KRd, its
// float64 twin.
//
// The golden product behind strategy='reference' and the plain CSR
// products (ops/reference.py: csr_matvec, csr_matmat). It replaces no
// Pallas kernel: the JAX package's reference product is XLA's gather
// and segment sum (tpusparse/ops/reference.py::spmv_reference).
//
// Computes Y (num_rows, L) = A @ X (num_cols, L), both row-major, one
// thread per row and lane:
//   Y[i, l] = (((+0 + v_p0 * X[c_p0, l]) + v_p1 * X[c_p1, l]) + ...),
// over the row's entries p in CSR order, each product and each sum
// rounded apart (rn_arith.cuh, no FMA contraction). That is the order in
// which the CPU's index_add_ adds the same products into a zero tensor,
// so the card gives the CPU's bits, and gives them again on every call:
// the index_add_ of CUDA adds with atomics in no fixed order. Speed is
// not the aim (a row of w entries takes w dependent adds on one thread).

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
csr_reference_kernel(const I* __restrict__ row_offsets,
                     const I* __restrict__ col_indices,
                     const T* __restrict__ values, const T* __restrict__ X,
                     T* __restrict__ Y, long long num_rows, int L) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= num_rows * L) return;
  const long long i = t / L;
  const int l = static_cast<int>(t - i * L);
  T acc = T(0);
  const long long end = row_offsets[i + 1];
  for (long long p = row_offsets[i]; p < end; ++p) {
    const long long c = col_indices[p];
    acc = tps_rn::add(acc, tps_rn::mul(values[p], X[c * L + l]));
  }
  Y[t] = acc;
}

template <typename T>
int launch(const void* row_offsets, const void* col_indices,
           const void* values, const void* X, void* Y, long long num_rows,
           int L, int index64, void* stream) {
  if (num_rows < 0 || L < 0 || (index64 != 0 && index64 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0 || L == 0) return 0;
  const long long total = num_rows * L;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) /
                                              kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const T*>(values);
  const auto* x = static_cast<const T*>(X);
  auto* y = static_cast<T*>(Y);
  if (index64) {
    csr_reference_kernel<T, long long><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(row_offsets),
        static_cast<const long long*>(col_indices), v, x, y, num_rows, L);
  } else {
    csr_reference_kernel<T, int><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(row_offsets),
        static_cast<const int*>(col_indices), v, x, y, num_rows, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (num_rows, L) = A @ X (num_cols, L) in float32 (KR): row_offsets and
// col_indices int32 (index64 = 0) or int64 (index64 = 1). Returns the
// cudaGetLastError() code after the launch.
extern "C" int tps_csr_reference(const void* row_offsets,
                                 const void* col_indices, const void* values,
                                 const void* X, void* Y, long long num_rows,
                                 int L, int index64, void* stream) {
  return launch<float>(row_offsets, col_indices, values, X, Y, num_rows, L,
                       index64, stream);
}

// The same in float64 (KRd).
extern "C" int tps_csr_reference_f64(const void* row_offsets,
                                     const void* col_indices,
                                     const void* values, const void* X,
                                     void* Y, long long num_rows, int L,
                                     int index64, void* stream) {
  return launch<double>(row_offsets, col_indices, values, X, Y, num_rows, L,
                        index64, stream);
}
