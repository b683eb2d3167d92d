// K1 — masked constant-coefficient DIA SpMV / SpMM for Hopper (sm_90a),
// and K1d, its float64 twin.
//
// K1 replaces the Pallas TPU kernel tpusparse/kernels/dia_stream.py::
// _spmm_dia_stream_edge_mask (body _dia_stream_kernel_edge_mask). K1d
// replaces _spmm_dia_stream_df_edge_mask (body
// _dia_stream_kernel_df_edge_mask), which computes the same y in
// double-float (two-f32) arithmetic because Mosaic has no 64-bit types;
// on Hopper float64 is native, so K1d is the same template at IEEE fp64:
// no hi/lo split of x, y or the coefficients.
//
// Computes, for each RHS lane l and row i of a square n x n operator,
//   y[l, i] = sum_k coef_k(i) * x[l, i + off_k],  k in offset order,
//   coef_k(i) = bit k of mask[i] ? vals[k] : 0.
// The mask word is uint32: bit 31 is legal (up to 32 planes); the JAX
// package views the same words as int32.
//
// Bound: bytes. At L = 1 a row moves 12 B in float32 (mask word 4, x 4,
// y 4) and 20 B in float64 (4 + 8 + 8); each further lane adds the x and
// y bytes only, since the mask is read once for all lanes. 2K flops a
// row and lane is far below the card's flop-per-byte balance in either
// type. The design:
//
//  1. A CTA owns a block of kThreads * R consecutive rows, a thread R of
//     them (R = kRowBytes / sizeof(T): 8 in float32, 4 in float64), and
//     the CTA walks all L lanes itself. The thread's R mask words stay in
//     registers for every lane, and each lane's R outputs leave in
//     16-byte stores.
//  2. A plane's R values of x come in 16-byte loads: from the address of
//     x[i0 + off] rounded down to 16 B, R / V + 1 vectors (R / V where
//     the address is aligned), shifted into place (V values a vector).
//     The shift is the same for every thread of a lane and plane, so the
//     branch on it is uniform. Only a run that reaches past 0 or n takes
//     guarded element loads. A row block's K shifted reads of x hit L1
//     after the first. K5 (dia_planes.cu) reads and writes its rows with
//     the same helpers (dia_rows.cuh).
// The A/B on the card (scripts/torch_k1_ab.py, PERF.md §6) kept these two
// steps and dropped windows of x in shared memory (cp.async, two
// stages): the kernel was slower with them than with these loads.
//
// Semantics kept from the TPU kernel: x[i + off] outside [0, n) reads 0
// (the TPU kernel's zero halo); in-range values are multiplied even when
// the coefficient is 0, as the TPU kernel's 0 * w is; products and sums
// round separately (no FMA contraction, rn_arith.cuh), in offset order,
// as the TPU kernel's select-multiply-add does. K1 and K1d therefore
// equal their plain versions bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "dia_rows.cuh"
#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kThreads = 256;
// bytes of a thread's run of rows (vectors: dia_rows.cuh)
constexpr int kRowBytes = 32;

using namespace tps_dia;

template <typename T>
__host__ __device__ constexpr int rows_per_thread() {
  return kRowBytes / static_cast<int>(sizeof(T));
}

template <typename T>
struct DiaParams {
  int offsets[kMaxPlanes];
  T vals[kMaxPlanes];
  int K;
};

template <int R>
__device__ __forceinline__ void load_mask(const uint32_t* __restrict__ mask,
                                          long long n, long long i0,
                                          uint32_t (&w)[R]) {
  if constexpr (R % 4 == 0) {
    if (i0 + R <= n && reinterpret_cast<uintptr_t>(mask + i0) % 16 == 0) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + i0) + q);
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) w[j] = i0 + j < n ? __ldg(mask + i0 + j) : 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_masked_kernel(const uint32_t* __restrict__ mask,
                  const T* __restrict__ xt, T* __restrict__ yt, long long n,
                  int L, const __grid_constant__ DiaParams<T> p) {
  constexpr int R = rows_per_thread<T>();
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (i0 >= n) return;
  uint32_t w[R];
  load_mask<R>(mask, n, i0, w);
  for (int l = 0; l < L; ++l) {
    const T* xl = xt + static_cast<long long>(l) * n;
    T acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = T(0);
    for (int k = 0; k < p.K; ++k) {
      T x[R];
      row_values<T, R>(xl, n, i0 + p.offsets[k], x);
      const T v = p.vals[k];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const T c = ((w[j] >> k) & 1u) ? v : T(0);
        acc[j] = tps_rn::add(acc[j], tps_rn::mul(c, x[j]));
      }
    }
    store_rows<T, R>(yt + static_cast<long long>(l) * n, n, i0, acc);
  }
}

template <typename T>
int launch(const void* mask, const void* xt, void* yt, long long n, int L,
           int K, const int* offsets, const T* vals, void* stream) {
  constexpr long long B = static_cast<long long>(kThreads) *
                          rows_per_thread<T>();
  if (K < 0 || K > kMaxPlanes || n < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || L == 0) return 0;
  DiaParams<T> p{};
  p.K = K;
  for (int k = 0; k < K; ++k) {
    p.offsets[k] = offsets[k];
    p.vals[k] = vals[k];
  }
  const unsigned grid = static_cast<unsigned>((n + B - 1) / B);
  dia_masked_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const T*>(xt),
      static_cast<T*>(yt), n, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yt (L, n) = A @ xt (L, n) for the masked operand (mask (n,), K planes),
// float32 (K1). offsets and vals are host arrays of K entries. Returns
// the cudaGetLastError() code after the launch.
extern "C" int tps_dia_masked(const void* mask, const void* xt, void* yt,
                              long long n, int L, int K, const int* offsets,
                              const float* vals, void* stream) {
  return launch<float>(mask, xt, yt, n, L, K, offsets, vals, stream);
}

// The same in float64 (K1d): xt, yt and vals are double.
extern "C" int tps_dia_masked_f64(const void* mask, const void* xt, void* yt,
                                  long long n, int L, int K,
                                  const int* offsets, const double* vals,
                                  void* stream) {
  return launch<double>(mask, xt, yt, n, L, K, offsets, vals, stream);
}

// K1's geometry for values of value_bytes (4 or 8) into out[3]: threads a
// CTA, rows a thread, values a vector load. Returns 0, or 1 for another
// value size.
extern "C" int tps_dia_masked_geometry(int value_bytes, int* out) {
  if (value_bytes != 4 && value_bytes != 8) return 1;
  const bool f64 = value_bytes == 8;
  out[0] = kThreads;
  out[1] = f64 ? rows_per_thread<double>() : rows_per_thread<float>();
  out[2] = f64 ? vector_elems<double>() : vector_elems<float>();
  return 0;
}
