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
// The design:
//
//  1. A CTA owns a block of kThreads * R consecutive rows, a thread R of
//     them (R = kRowBytes / sizeof(T): 4 with float32 and bf16 planes, 2
//     in float64), and the CTA walks every lane itself, one at a time, as
//     K1 does. Each lane's R outputs leave in one 16-byte store.
//  2. At L > 1 the first lane stages the thread's plane values in shared
//     memory laid out [plane][thread][row] (K * kThreads * R values, up to
//     kMaxTileBytes; past it every lane reads the planes from global
//     memory), and the other lanes read them from there: the planes cross
//     DRAM once a call at any L. Each lane's accumulators sum k = 0..K-1
//     in order.
//  3. x comes in guarded element loads, a thread's R neighbours in one
//     row of the lane; the warp's loads of a plane cover consecutive
//     rows.
// The A/B on the card (scripts/torch_k5_ab.py, PERF.md §6) chose these
// over C lanes' accumulators a thread, 32 bytes of rows a thread, and
// 16-byte loads of the planes and of x (K1's reads, 5 % slower here).
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

#include "dia_rows.cuh"
#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 64;
constexpr int kThreads = 256;
// bytes of a thread's run of rows (its stores: dia_rows.cuh)
constexpr int kRowBytes = 16;
// the most shared memory a CTA's plane tile takes (Hopper's 227 KiB), and
// what a launch gets without raising the kernel's limit
constexpr int kMaxTileBytes = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

using namespace tps_dia;

template <typename T>
__host__ __device__ constexpr int rows_per_thread() {
  return kRowBytes / static_cast<int>(sizeof(T));
}

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
// float32 and bf16 planes, double for float64 planes). Tile: lanes after
// the first read the planes from the CTA's shared-memory tile.
template <typename PlaneT, typename T, bool Tile>
__global__ void __launch_bounds__(kThreads)
dia_planes_kernel(const PlaneT* __restrict__ planes,
                  const T* __restrict__ xt, T* __restrict__ yt,
                  long long num_rows, long long num_cols, int L,
                  const __grid_constant__ PlaneParams p) {
  constexpr int R = rows_per_thread<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this thread's R values of plane k at mine + k * kThreads * R
  PlaneT* mine = reinterpret_cast<PlaneT*>(smem_raw) + threadIdx.x * R;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (i0 >= num_rows) return;
  for (int l = 0; l < L; ++l) {
    const T* xl = xt + static_cast<long long>(l) * num_cols;
    T acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = T(0);
    for (int k = 0; k < p.K; ++k) {
      PlaneT* tk = mine + k * kThreads * R;
      T d[R];
      if (Tile && l > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) d[j] = upcast(tk[j]);
      } else {
        const PlaneT* pk = planes + k * num_rows + i0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const PlaneT v = i0 + j < num_rows ? __ldg(pk + j) : PlaneT{};
          d[j] = upcast(v);
          if (Tile) tk[j] = v;
        }
      }
      T x[R];
      const long long c0 = i0 + p.offsets[k];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        x[j] = (c0 + j >= 0 && c0 + j < num_cols) ? __ldg(xl + c0 + j) : T(0);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[j] = tps_rn::add(acc[j], tps_rn::mul(d[j], x[j]));
      }
    }
    store_rows<T, R>(yt + static_cast<long long>(l) * num_rows, num_rows, i0,
                     acc);
  }
}

template <typename PlaneT, typename T>
int launch(const void* planes, const void* xt, void* yt, long long num_rows,
           long long num_cols, int L, int K, const long long* offsets,
           void* stream) {
  constexpr long long B = static_cast<long long>(kThreads) *
                          rows_per_thread<T>();
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
  const unsigned grid = static_cast<unsigned>((num_rows + B - 1) / B);
  const size_t tile = static_cast<size_t>(K) * B * sizeof(PlaneT);
  if (L == 1 || tile > static_cast<size_t>(kMaxTileBytes)) {
    dia_planes_kernel<PlaneT, T, false><<<grid, kThreads, 0, s>>>(
        P, X, Y, num_rows, num_cols, L, p);
    return static_cast<int>(cudaGetLastError());
  }
  auto* kernel = dia_planes_kernel<PlaneT, T, true>;
  if (tile > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, tile, s>>>(P, X, Y, num_rows, num_cols, L, p);
  return static_cast<int>(cudaGetLastError());
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

// K5's geometry for values of value_bytes (4: K5 with float32 or bf16
// planes, 8: K5d) into out[3]: threads a CTA, rows a thread, values a
// 16-byte store of y. Returns 0, or 1 for another value size.
extern "C" int tps_dia_planes_geometry(int value_bytes, int* out) {
  if (value_bytes != 4 && value_bytes != 8) return 1;
  const bool f64 = value_bytes == 8;
  out[0] = kThreads;
  out[1] = f64 ? rows_per_thread<double>() : rows_per_thread<float>();
  out[2] = f64 ? vector_elems<double>() : vector_elems<float>();
  return 0;
}
