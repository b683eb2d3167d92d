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
//  2. x is read one run of planes at a time. A run is a maximal sequence
//     of planes whose offsets follow one another (off, off + 1, ...),
//     found on the host when the operand is built and cut at kMaxRun
//     planes (kernels/dia_stream.py::plane_runs). For a run of M planes
//     a thread reads the R + M - 1 values x[i0 + off .. i0 + off + R +
//     M - 2] once, as one window in registers, and serves all M planes
//     from it: HPCG's 27-point band is nine runs of three (dx = -1, 0,
//     +1), nine windows a lane instead of 27 reads. A window comes in the
//     16-byte vectors it spans from the address of x[i0 + off] rounded
//     down to 16 B. Its shift (V values a vector) is the same for every
//     thread of a lane and run, so the kernel branches on it uniformly to
//     an instance that reads each value where it was loaded: no copies,
//     and the registers of one window. Only a window that reaches past 0
//     or n takes guarded element loads (window_values, dia_rows.cuh; K5,
//     dia_planes.cu, stores its rows with the same header). A band with
//     no consecutive offsets reads one plane at a time, as R values.
// On HPCG's band the kernel is bound by load instructions through L1,
// not by bytes (each warp-wide 16-byte load of x, 32 bytes apart a
// thread, costs several L1 wavefronts), so the windows save what they
// take off those loads. The A/B on the card (scripts/torch_k1_ab.py,
// PERF.md §6) kept step 1 and its R, dropped windows of x in shared
// memory (cp.async, two stages: slower than these loads), and chose
// register windows read where they were loaded, runs of at most three
// planes and the launch bounds below. Windows shifted into place by
// copies, or of up to four planes, took 60-75 registers a thread and ran
// the 7-point band slower than one plane at a time; taking a window's
// edge from the next lane by warp shuffles was slower than loading it.
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
// planes of the longest run read as one window of x (registers: each
// length and shift is an instance, and a fourth plane's took K1d from
// 48 to 75 registers a thread)
constexpr int kMaxRun = 3;

using namespace tps_dia;

template <typename T>
__host__ __device__ constexpr int rows_per_thread() {
  return kRowBytes / static_cast<int>(sizeof(T));
}

template <typename T>
struct DiaParams {
  int offsets[kMaxPlanes];
  T vals[kMaxPlanes];
  // planes of each run, in plane order: 1 to kMaxRun each, K in all
  int runs[kMaxPlanes];
  int K;
  int num_runs;
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

// Planes k .. k + M - 1, one run (offsets[k + q] = offsets[k] + q), of
// the thread's R rows from i0 in lane xl, added to acc in plane order
// from one window of the R + M - 1 values of x the run reads, x[c ..],
// c = i0 + offsets[k], which lies S elements past a 16-byte boundary.
template <typename T, int R, int M, int S>
__device__ __forceinline__ void add_run_at(const T* __restrict__ xl,
                                           long long n, long long c,
                                           const DiaParams<T>& p, int k,
                                           const uint32_t (&w)[R],
                                           T (&acc)[R]) {
  T x[window_span<T>(R + M - 1, S)];
  window_values<T, R + M - 1, S>(xl, n, c, x);
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const T v = p.vals[k + q];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T coef = ((w[j] >> (k + q)) & 1u) ? v : T(0);
      acc[j] = tps_rn::add(acc[j], tps_rn::mul(coef, x[S + j + q]));
    }
  }
}

// add_run_at for the shift s, 0 <= s < V, and a run of m planes,
// 1 <= m <= M: each shift and length has its own instance (the branches
// are uniform: every thread of a lane has the same runs and shifts).
template <typename T, int R, int M, int S = 0>
__device__ __forceinline__ void add_run(int s, int m,
                                        const T* __restrict__ xl,
                                        long long n, long long c,
                                        const DiaParams<T>& p, int k,
                                        const uint32_t (&w)[R],
                                        T (&acc)[R]) {
  if constexpr (M > 1) {
    if (m < M) {
      add_run<T, R, M - 1, S>(s, m, xl, n, c, p, k, w, acc);
      return;
    }
  }
  if constexpr (S + 1 < vector_elems<T>()) {
    if (s > S) {
      add_run<T, R, M, S + 1>(s, m, xl, n, c, p, k, w, acc);
      return;
    }
  }
  add_run_at<T, R, M, S>(xl, n, c, p, k, w, acc);
}

// The launch bounds ask for six CTAs an SM in float64, which holds K1d to
// 40 registers a thread (at 48, five CTAs, the 7-point band at L = 16 ran
// slower than with one plane a read), and four in float32, which leave K1
// the 54 it takes (PERF.md §6).
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 8 ? 6 : 4)
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
    for (int r = 0, k = 0; r < p.num_runs; k += p.runs[r++]) {
      const long long c = i0 + p.offsets[k];
      add_run<T, R, kMaxRun>(misalign(xl, c), p.runs[r], xl, n, c, p, k, w,
                             acc);
    }
    store_rows<T, R>(yt + static_cast<long long>(l) * n, n, i0, acc);
  }
}

template <typename T>
int launch(const void* mask, const void* xt, void* yt, long long n, int L,
           int K, const int* offsets, const T* vals, int num_runs,
           const int* runs, void* stream) {
  constexpr long long B = static_cast<long long>(kThreads) *
                          rows_per_thread<T>();
  if (K < 0 || K > kMaxPlanes || n < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiaParams<T> p{};
  p.K = K;
  p.num_runs = num_runs;
  for (int k = 0; k < K; ++k) {
    p.offsets[k] = offsets[k];
    p.vals[k] = vals[k];
  }
  // the runs cover the K planes in order, each of consecutive offsets
  int k = 0;
  for (int r = 0; r < num_runs; ++r) {
    if (runs[r] < 1 || runs[r] > kMaxRun || k + runs[r] > K) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int q = 1; q < runs[r]; ++q) {
      if (offsets[k + q] != offsets[k] + q) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    p.runs[r] = runs[r];
    k += runs[r];
  }
  if (k != K) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || L == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + B - 1) / B);
  dia_masked_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const T*>(xt),
      static_cast<T*>(yt), n, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yt (L, n) = A @ xt (L, n) for the masked operand (mask (n,), K planes),
// float32 (K1). offsets and vals are host arrays of K entries; runs a
// host array of num_runs entries, the planes of each run in plane order
// (1 to kMaxRun each, K in all, each run of consecutive offsets). Returns
// the cudaGetLastError() code after the launch, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int tps_dia_masked(const void* mask, const void* xt, void* yt,
                              long long n, int L, int K, const int* offsets,
                              const float* vals, int num_runs,
                              const int* runs, void* stream) {
  return launch<float>(mask, xt, yt, n, L, K, offsets, vals, num_runs, runs,
                       stream);
}

// The same in float64 (K1d): xt, yt and vals are double.
extern "C" int tps_dia_masked_f64(const void* mask, const void* xt, void* yt,
                                  long long n, int L, int K,
                                  const int* offsets, const double* vals,
                                  int num_runs, const int* runs,
                                  void* stream) {
  return launch<double>(mask, xt, yt, n, L, K, offsets, vals, num_runs, runs,
                        stream);
}

// K1's geometry for values of value_bytes (4 or 8) into out[4]: threads a
// CTA, rows a thread, values a vector load, planes of the longest run.
// Returns 0, or 1 for another value size.
extern "C" int tps_dia_masked_geometry(int value_bytes, int* out) {
  if (value_bytes != 4 && value_bytes != 8) return 1;
  const bool f64 = value_bytes == 8;
  out[0] = kThreads;
  out[1] = f64 ? rows_per_thread<double>() : rows_per_thread<float>();
  out[2] = f64 ? vector_elems<double>() : vector_elems<float>();
  out[3] = kMaxRun;
  return 0;
}
