// Row-run reads and writes of the DIA kernels K1 (dia_masked.cu) and K5
// (dia_planes.cu), and their float64 twins.
//
// A thread of either kernel owns a run of R consecutive rows and writes
// its R outputs of a lane in 16-byte stores where they lie on a 16-byte
// boundary inside [0, n), else element by element (store_rows: K1 and
// K5). K1 reads a run of R values of x at a plane's offset in 16-byte
// vectors from the address rounded down to 16 bytes and shifts them into
// place; the shift is the same for every thread of a lane and plane, so
// the branch on it is uniform. Only a run that reaches past 0 or n takes
// guarded element loads, which read 0 outside [0, n) (row_values: K1;
// K5's A/B found its element loads faster).

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

// v[j] = p[c + j] for j < R, 0 outside [0, n): 16-byte loads from
// p + c - s (s = c's misalignment) where the run lies inside [0, n),
// else guarded element loads.
template <typename E, int R>
__device__ __forceinline__ void row_values(const E* __restrict__ p,
                                           long long n, long long c,
                                           E (&v)[R]) {
  constexpr int V = vector_elems<E>();
  if constexpr (R % V == 0) {
    const int s = misalign(p, c);
    if (c - s >= 0 && c - s + R + V <= n) {
      using VT = typename Vec<E>::type;
      constexpr int C = R / V;
      const VT* pv = reinterpret_cast<const VT*>(p + (c - s));
      E buf[(C + 1) * V];
#pragma unroll
      for (int q = 0; q < C; ++q) unpack(__ldg(pv + q), buf + q * V);
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) v[j] = buf[j];
        return;
      }
      unpack(__ldg(pv + C), buf + C * V);
#pragma unroll
      for (int t = 1; t < V; ++t) {
        if (s == t) {
#pragma unroll
          for (int j = 0; j < R; ++j) v[j] = buf[j + t];
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    v[j] = (c + j >= 0 && c + j < n) ? __ldg(p + c + j) : E{};
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
