// Row-run reads and writes of the DIA kernels K1 (dia_masked.cu) and K5
// (dia_planes.cu), and their float64 twins.
//
// A thread of either kernel owns a run of R consecutive rows and writes
// its R outputs of a lane in 16-byte stores where they lie on a 16-byte
// boundary inside [0, n), else element by element (store_rows: K1 and
// K5). K1 reads a window of W consecutive values of x (the R values of a
// plane's offset, and the M - 1 more of a run of M consecutive offsets:
// W = R + M - 1) in the 16-byte vectors it spans, from the address
// rounded down to 16 bytes. The shift is the same for every thread of a
// lane and run, so K1 branches on it uniformly to an instance that reads
// each value where it was loaded. Only a window whose vectors reach past
// 0 or n takes guarded element loads, which read 0 outside [0, n)
// (window_values: K1; K5's A/B found its element loads faster).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Inline and template definitions only, so each translation unit that
// includes this header may define them. No anonymous namespace: the
// kernels pull these names into their own with a using-directive, which
// nvcc's host stubs cannot resolve against a second anonymous namespace.
namespace tps_dia {

// bytes of a vector load or store
constexpr int kVectorBytes = 16;

template <typename E>
__host__ __device__ constexpr int vector_elems() {
  return kVectorBytes / static_cast<int>(sizeof(E));
}

template <typename E>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
};

__device__ __forceinline__ void unpack(float4 v, float* b) {
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void unpack(double2 v, double* b) {
  b[0] = v.x;
  b[1] = v.y;
}
__device__ __forceinline__ void unpack(uint4 v, __nv_bfloat16* b) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q) b[q] = h[q];
}
__device__ __forceinline__ float4 pack(const float* b) {
  return make_float4(b[0], b[1], b[2], b[3]);
}
__device__ __forceinline__ double2 pack(const double* b) {
  return make_double2(b[0], b[1]);
}

// Elements by which p + i lies past a kVectorBytes boundary (i may be
// negative: the address arithmetic wraps, the remainder does not).
template <typename E>
__device__ __forceinline__ int misalign(const E* p, long long i) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) +
                      static_cast<uintptr_t>(i) * sizeof(E);
  return static_cast<int>((a & (kVectorBytes - 1)) / sizeof(E));
}

// Elements of the whole vectors that a window of W values spans when it
// starts S elements past a vector boundary.
template <typename E>
__host__ __device__ constexpr int window_span(int W, int S) {
  return (S + W + vector_elems<E>() - 1) / vector_elems<E>() *
         vector_elems<E>();
}

// b[S + e] = p[c + e] for e < W, 0 outside [0, n), where p + c lies S
// elements past a 16-byte boundary: the N = window_span(W, S) elements
// from p + c - S in 16-byte loads where they lie inside [0, n), else
// guarded element loads. S is a compile-time constant, so the values are
// used where they were loaded, with no shift.
template <typename E, int W, int S, int N>
__device__ __forceinline__ void window_values(const E* __restrict__ p,
                                              long long n, long long c,
                                              E (&b)[N]) {
  static_assert(N == window_span<E>(W, S), "window buffer size");
  constexpr int V = vector_elems<E>();
  if (c - S >= 0 && c - S + N <= n) {
    using VT = typename Vec<E>::type;
    const VT* pv = reinterpret_cast<const VT*>(p + (c - S));
#pragma unroll
    for (int q = 0; q < N / V; ++q) unpack(__ldg(pv + q), b + q * V);
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e) {
    b[S + e] = (c + e >= 0 && c + e < n) ? __ldg(p + c + e) : E{};
  }
}

// A thread's R outputs of one lane yl: 16-byte stores where they lie in
// [0, n) on a 16-byte boundary, else element by element.
template <typename T, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ yl, long long n,
                                           long long i0, const T (&acc)[R]) {
  constexpr int V = vector_elems<T>();
  if constexpr (R % V == 0) {
    if (i0 + R <= n && reinterpret_cast<uintptr_t>(yl + i0) % 16 == 0) {
      using VT = typename Vec<T>::type;
#pragma unroll
      for (int q = 0; q < R / V; ++q) {
        reinterpret_cast<VT*>(yl + i0)[q] = pack(acc + q * V);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (i0 + j < n) yl[i0 + j] = acc[j];
  }
}

}  // namespace tps_dia
