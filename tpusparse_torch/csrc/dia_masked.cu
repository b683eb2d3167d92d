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
// Bound: bytes. At L = 1 a row moves 12 B in float32 (mask word 4, x
// about 4 since the K shifted reads of x hit L1/L2 after the first, y 4)
// and 20 B in float64 (4 + 8 + 8), for 2K flops, far below the card's
// flop-per-byte balance in either type. The design streams the three
// arrays once with coalesced accesses — one thread per row, neighbouring
// threads on neighbouring rows — and keeps the K offsets and
// coefficients in kernel parameters (by value, constant bank; 388 B of
// parameters in float64), so the only per-row operand traffic is the
// mask word. The TPU kernel's edge-halo staging of x is not needed: the
// cache serves the K shifted reads. Faster forms (vector loads, x tiles
// in shared memory) are later work.
//
// Semantics kept from the TPU kernel: the load of x[i + off] is guarded,
// so an out-of-range neighbour reads 0 (the TPU kernel's zero halo);
// in-range loads are multiplied even when the coefficient is 0, as the
// TPU kernel's 0 * w is; products and sums round separately (no FMA
// contraction, rn_arith.cuh), as the TPU kernel's select-multiply-add
// does. K1 and K1d therefore equal their plain versions bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T>
struct DiaParams {
  int offsets[kMaxPlanes];
  T vals[kMaxPlanes];
  int K;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_masked_kernel(const uint32_t* __restrict__ mask,
                  const T* __restrict__ xt, T* __restrict__ yt, long long n,
                  int L, DiaParams<T> p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const uint32_t w = mask[i];
  for (int l = blockIdx.y; l < L; l += gridDim.y) {
    const T* x = xt + static_cast<long long>(l) * n;
    T acc = T(0);
    for (int k = 0; k < p.K; ++k) {
      const long long j = i + p.offsets[k];
      const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
      const T c = ((w >> k) & 1u) ? p.vals[k] : T(0);
      acc = tps_rn::add(acc, tps_rn::mul(c, xv));
    }
    yt[static_cast<long long>(l) * n + i] = acc;
  }
}

template <typename T>
int launch(const void* mask, const void* xt, void* yt, long long n, int L,
           int K, const int* offsets, const T* vals, void* stream) {
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
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(L < kMaxGridY ? L : kMaxGridY));
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
