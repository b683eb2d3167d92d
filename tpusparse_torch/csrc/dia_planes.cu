// K5 — value-plane DIA SpMV / SpMM for Hopper (sm_90a), float32 or bf16
// planes.
//
// Replaces the Pallas TPU kernel tpusparse/kernels/dia_stream.py::
// _spmm_dia_stream_edge (body _dia_stream_kernel_edge) and its MXU-rotation
// variant _spmm_dia_stream_edge_mxu (body _dia_stream_kernel_edge_mxu),
// whose selection matmul is an exact 0/1 selection: both compute the same y.
//
// Computes, for each RHS lane l < L and row i < num_rows of a
// num_rows x num_cols operator held as K value planes (K, num_rows),
//   y[l, i] = sum_k d_k(i) * x[l, i + off_k],  k in offset order,
// d_k(i) = planes[k, i], stored float32 or bf16 and upcast in-register.
//
// Bound: bytes. At L = 1 a row reads K plane values (4 or 2 B each) against
// 8 B of x and y: a 27-point variable stencil reads 108 B/row of f32 planes
// (54 B in bf16), for 2K flops. One thread per row, neighbouring threads on
// neighbouring rows, so each plane's loads are coalesced across the warp;
// the K shifted reads of x are served by L1/L2, as in K1. The TPU kernel
// reads a plane block once for all L lanes (its plane index map ignores the
// lane grid axis); here each thread copies its row's K coefficients once
// into its own column of a shared-memory tile and then sweeps the lanes in
// register chunks of C, so plane traffic is once per call at any L. Faster
// forms (vector loads, x tiles in shared memory, TMA) are later work.
//
// Semantics kept from the TPU kernel: the load of x[l, i + off] is guarded,
// so a column outside [0, num_cols) reads 0 (the TPU kernel's zero halo);
// in-range loads are multiplied even where the coefficient is 0, so 0 * inf
// and 0 * nan give nan as on the TPU; products and sums round separately
// (no FMA contraction), in offset order. K5 therefore equals its plain
// version bit for bit, and equals K1 bit for bit on a constant-coefficient
// operator.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 64;
constexpr int kThreads = 128;

struct PlaneParams {
  long long offsets[kMaxPlanes];
  int K;
};

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// C: lanes held in registers per sweep (1, 4 or 16, chosen from L).
template <typename PlaneT, int C>
__global__ void __launch_bounds__(kThreads)
dia_planes_kernel(const PlaneT* __restrict__ planes,
                  const float* __restrict__ xt, float* __restrict__ yt,
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
    const float* x = xt + static_cast<long long>(l0) * num_cols;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int k = 0; k < p.K; ++k) {
      const float d = upcast(coef[k * kThreads + threadIdx.x]);
      const long long j = i + p.offsets[k];
      const bool in = j >= 0 && j < num_cols;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < lanes) {
          const float xv = in ? __ldg(x + c * num_cols + j) : 0.0f;
          acc[c] = __fadd_rn(acc[c], __fmul_rn(d, xv));
        }
      }
    }
    float* y = yt + static_cast<long long>(l0) * num_rows + i;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < lanes) y[c * num_rows] = acc[c];
    }
  }
}

template <typename PlaneT>
cudaError_t launch(const void* planes, const void* xt, void* yt,
                   long long num_rows, long long num_cols, int L,
                   const PlaneParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_rows + kThreads - 1) /
                                        kThreads));
  const size_t smem = static_cast<size_t>(p.K) * kThreads * sizeof(PlaneT);
  const auto* P = static_cast<const PlaneT*>(planes);
  const auto* X = static_cast<const float*>(xt);
  auto* Y = static_cast<float*>(yt);
  if (L == 1) {
    dia_planes_kernel<PlaneT, 1><<<grid, kThreads, smem, stream>>>(
        P, X, Y, num_rows, num_cols, L, p);
  } else if (L <= 4) {
    dia_planes_kernel<PlaneT, 4><<<grid, kThreads, smem, stream>>>(
        P, X, Y, num_rows, num_cols, L, p);
  } else {
    dia_planes_kernel<PlaneT, 16><<<grid, kThreads, smem, stream>>>(
        P, X, Y, num_rows, num_cols, L, p);
  }
  return cudaGetLastError();
}

}  // namespace

// yt (L, num_rows) = A @ xt (L, num_cols) for K value planes (K, num_rows),
// float32 (plane_bf16 = 0) or bf16 (plane_bf16 = 1). offsets is a host
// array of K entries. n = 0, L = 0 and K = 0 launch nothing (the caller
// zero-fills for K = 0). Returns the cudaGetLastError() code after the
// launch.
extern "C" int tps_dia_planes(const void* planes, int plane_bf16,
                              const void* xt, void* yt, long long num_rows,
                              long long num_cols, int L, int K,
                              const long long* offsets, void* stream) {
  if (K < 0 || K > kMaxPlanes || num_rows < 0 || num_cols < 0 || L < 0 ||
      (plane_bf16 != 0 && plane_bf16 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0 || L == 0 || K == 0) return 0;
  PlaneParams p{};
  p.K = K;
  for (int k = 0; k < K; ++k) p.offsets[k] = offsets[k];
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      plane_bf16 ? launch<__nv_bfloat16>(planes, xt, yt, num_rows, num_cols,
                                         L, p, s)
                 : launch<float>(planes, xt, yt, num_rows, num_cols, L, p, s);
  return static_cast<int>(err);
}
