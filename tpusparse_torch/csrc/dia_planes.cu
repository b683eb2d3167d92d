// K5 — value-plane DIA SpMV / SpMM for Hopper (sm_90a), float32 or bf16
// planes; and K5d, its float64 twin.
//
// K5 replaces the Pallas TPU kernel tpusparse/kernels/dia_stream.py::
// _spmm_dia_stream_edge (body _dia_stream_kernel_edge) and its MXU-rotation
// variant _spmm_dia_stream_edge_mxu (body _dia_stream_kernel_edge_mxu),
// whose selection matmul is an exact 0/1 selection: both compute the same y.
// K5d replaces _spmm_dia_stream_df_edge (body _dia_stream_kernel_df_edge),
// which computes the same y on hi/lo f32 plane pairs in double-float
// arithmetic because Mosaic has no 64-bit types; here the planes, x, y and
// the accumulator are IEEE float64.
//
// Computes, for each RHS lane l < L and row i < num_rows of a
// num_rows x num_cols operator held as K value planes (K, num_rows),
//   y[l, i] = sum_k d_k(i) * x[l, i + off_k],  k in offset order,
// d_k(i) = planes[k, i]: float32 or bf16 planes upcast in-register to the
// float32 accumulator (K5), float64 planes with a float64 accumulator (K5d).
//
// Bound: bytes. At L = 1 a row reads K plane values (4 or 2 B each; 8 B in
// K5d) against the x and y streams: a 27-point variable stencil reads
// 108 B/row of f32 planes (54 B in bf16, 216 B in float64), for 2K flops.
// One thread per row, neighbouring threads on neighbouring rows, so each
// plane's loads are coalesced across the warp; the K shifted reads of x are
// served by L1/L2, as in K1. The TPU kernel reads a plane block once for
// all L lanes (its plane index map ignores the lane grid axis); here each
// thread copies its row's K coefficients once into its own column of a
// shared-memory tile and then sweeps the lanes in register chunks of C, so
// plane traffic is once per call at any L. In float64 the (K, 128) tile is
// 64 KiB at K = 64, past the 48 KiB a launch gets by default: the launch
// raises the kernel's dynamic shared-memory limit first. Faster forms
// (vector loads, x tiles in shared memory, TMA) are later work.
//
// Semantics kept from the TPU kernel: the load of x[l, i + off] is guarded,
// so a column outside [0, num_cols) reads 0 (the TPU kernel's zero halo);
// in-range loads are multiplied even where the coefficient is 0, so 0 * inf
// and 0 * nan give nan as on the TPU; products and sums round separately
// (no FMA contraction, rn_arith.cuh), in offset order. K5 and K5d therefore
// equal their plain versions bit for bit, and K1 (K1d) bit for bit on a
// constant-coefficient operator.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 64;
constexpr int kThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

struct PlaneParams {
  long long offsets[kMaxPlanes];
  int K;
};

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double upcast(double v) { return v; }

// PlaneT: the stored plane type; T: x, y and the accumulator (float for
// float32 and bf16 planes, double for float64 planes). C: lanes held in
// registers per sweep (1, 4 or 16, chosen from L).
template <typename PlaneT, typename T, int C>
__global__ void __launch_bounds__(kThreads)
dia_planes_kernel(const PlaneT* __restrict__ planes,
                  const T* __restrict__ xt, T* __restrict__ yt,
                  long long num_rows, long long num_cols, int L,
                  PlaneParams p) {
  extern __shared__ unsigned char smem_raw[];
  // column threadIdx.x of a (K, kThreads) tile: this thread's coefficients
  PlaneT* coef = reinterpret_cast<PlaneT*>(smem_raw);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= num_rows) return;
  for (int k = 0; k < p.K; ++k) {
    coef[k * kThreads + threadIdx.x] = planes[k * num_rows + i];
  }
  for (int l0 = 0; l0 < L; l0 += C) {
    const int lanes = L - l0 < C ? L - l0 : C;
    const T* x = xt + static_cast<long long>(l0) * num_cols;
    T acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = T(0);
    for (int k = 0; k < p.K; ++k) {
      const T d = upcast(coef[k * kThreads + threadIdx.x]);
      const long long j = i + p.offsets[k];
      const bool in = j >= 0 && j < num_cols;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < lanes) {
          const T xv = in ? __ldg(x + c * num_cols + j) : T(0);
          acc[c] = tps_rn::add(acc[c], tps_rn::mul(d, xv));
        }
      }
    }
    T* y = yt + static_cast<long long>(l0) * num_rows + i;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < lanes) y[c * num_rows] = acc[c];
    }
  }
}

template <typename PlaneT, typename T, int C>
cudaError_t launch_c(const PlaneT* planes, const T* xt, T* yt,
                     long long num_rows, long long num_cols, int L,
                     const PlaneParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_rows + kThreads - 1) /
                                        kThreads));
  const size_t smem = static_cast<size_t>(p.K) * kThreads * sizeof(PlaneT);
  auto* kernel = dia_planes_kernel<PlaneT, T, C>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(planes, xt, yt, num_rows,
                                           num_cols, L, p);
  return cudaGetLastError();
}

template <typename PlaneT, typename T>
int launch(const void* planes, const void* xt, void* yt, long long num_rows,
           long long num_cols, int L, int K, const long long* offsets,
           void* stream) {
  if (K < 0 || K > kMaxPlanes || num_rows < 0 || num_cols < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0 || L == 0 || K == 0) return 0;
  PlaneParams p{};
  p.K = K;
  for (int k = 0; k < K; ++k) p.offsets[k] = offsets[k];
  const auto* P = static_cast<const PlaneT*>(planes);
  const auto* X = static_cast<const T*>(xt);
  auto* Y = static_cast<T*>(yt);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (L == 1) {
    err = launch_c<PlaneT, T, 1>(P, X, Y, num_rows, num_cols, L, p, s);
  } else if (L <= 4) {
    err = launch_c<PlaneT, T, 4>(P, X, Y, num_rows, num_cols, L, p, s);
  } else {
    err = launch_c<PlaneT, T, 16>(P, X, Y, num_rows, num_cols, L, p, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// yt (L, num_rows) = A @ xt (L, num_cols) for K value planes (K, num_rows),
// float32 (plane_bf16 = 0) or bf16 (plane_bf16 = 1), with float32 xt and yt
// (K5). offsets is a host array of K entries. n = 0, L = 0 and K = 0 launch
// nothing (the caller zero-fills for K = 0). Returns the cudaGetLastError()
// code after the launch.
extern "C" int tps_dia_planes(const void* planes, int plane_bf16,
                              const void* xt, void* yt, long long num_rows,
                              long long num_cols, int L, int K,
                              const long long* offsets, void* stream) {
  if (plane_bf16 == 0) {
    return launch<float, float>(planes, xt, yt, num_rows, num_cols, L, K,
                                offsets, stream);
  }
  if (plane_bf16 == 1) {
    return launch<__nv_bfloat16, float>(planes, xt, yt, num_rows, num_cols,
                                        L, K, offsets, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for float64 planes, xt and yt (K5d).
extern "C" int tps_dia_planes_f64(const void* planes, const void* xt,
                                  void* yt, long long num_rows,
                                  long long num_cols, int L, int K,
                                  const long long* offsets, void* stream) {
  return launch<double, double>(planes, xt, yt, num_rows, num_cols, L, K,
                                offsets, stream);
}
