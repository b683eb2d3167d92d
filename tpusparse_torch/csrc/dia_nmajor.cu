// K7 — n-major masked constant-coefficient DIA SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpusparse/kernels/dia_nmajor.py::
// _spmm_nmajor (body _nmajor_kernel). That kernel keeps the right-hand
// sides in their natural row-major (n, L) layout because the TPU's
// lane-major masked kernel pays a lane rotation per RHS step; it views the
// block as flat (T, 128) registers, packs G = 128 / L rows' presence bits
// into each int32 word, and pads L up to a divisor of 128 with guard
// blocks around the state. On Hopper the function is K1 (dia_masked.cu)
// reading and writing (n, L) directly, and none of the TPU layout
// survives: X and Y are unpadded row-major (n, L), element (i, l) at
// i * L + l, so a shift by offset o is a flat shift by o * L, and the
// mask is K1's (n,) uint32 words.
//
// Computes, for each row i and RHS lane l of a square n x n operator,
//   y[i, l] = sum_k coef_k(i) * x[i + off_k, l],  k in offset order,
//   coef_k(i) = bit k of mask[i] ? vals[k] : 0,
// with K1's contract: an out-of-range row reads 0; an in-range load is
// multiplied even by a zero coefficient; products and sums round
// separately (rn_arith.cuh). So K7 equals its plain version bit for bit,
// and equals K1 on X^T, transposed back, bit for bit.
//
// Bound: bytes. A row moves 4 B of mask word plus 4 L B of x and of y, for
// 2 K L flops: far below the card's flop-per-byte balance. The design:
//
//  1. A thread owns kRows rows and one lane group of V values (V = 4
//     when L % 4 == 0, 2 when L % 2 == 0, else 1: a template parameter
//     the wrapper picks from L and the pointers' alignment). The G = L / V
//     threads of a row are neighbours, and a sub-block's runs = kThreads
//     / G row slots hold consecutive rows: the thread's rows are its slot
//     and the slots kRows - 1 times runs rows further on. So each load
//     of a warp reads 32 V values of consecutive rows, one contiguous
//     run of x, at every L. In (n, L) every shifted read is aligned: row
//     i + off starts at (i + off) L 4 B, a multiple of 4 V bytes, so K1's
//     shift-and-realign step has no counterpart here. (kRows consecutive
//     rows a thread, the first design, left a warp's load of one row
//     spread over a quarter of each sector at L = 4: 51 % slower there,
//     5 % on the geometric mean of the A/B's cells.)
//  2. The thread loads its kRows mask words once; they serve all K
//     planes.
//  3. For each plane in offset order the thread reads its kRows rows of x
//     at that offset in V-wide loads and adds into kRows V-wide
//     accumulators; only a thread whose rows reach past row 0 or row n
//     takes guarded loads (the branch is uniform over the G threads of a
//     row). Y leaves in V-wide stores.
//  4. A CTA walks kSubBlocks consecutive sub-blocks of (kThreads / G)
//     kRows rows in order. The aim was a CTA whose rows span three times
//     its second-largest |offset| (1,024 rows at L = 16 with four
//     sub-blocks, against lap3d-160's +-160 planes), so that the near
//     planes hit L1. The A/B on the card (scripts/torch_k7_ab.py,
//     PERF.md §6) found one sub-block a CTA 9 % faster than four and
//     eight 12 % slower: more, shorter CTAs fill the card better than
//     L1 reuse across sub-blocks pays. So kSubBlocks is 1; the walk stays
//     as the A/B's knob.
// The geometry constants below are mirrored in kernels/dia_nmajor.py and
// checked against the library at every launch (tps_dia_nmajor_geometry).
// The K offsets and coefficients travel by value in kernel parameters.

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kThreads = 256;
// rows a thread (step 1)
constexpr int kRows = 4;
// sub-blocks a CTA walks in order (step 4)
constexpr int kSubBlocks = 1;
// bytes of the widest lane group (V = 4 floats)
constexpr int kVectorBytes = 16;

struct NMajorParams {
  int offsets[kMaxPlanes];
  float vals[kMaxPlanes];
  int K;
};

template <int V>
struct Lanes;
template <>
struct Lanes<1> {
  using type = float;
  __device__ static void unpack(float v, float* b) { b[0] = v; }
  __device__ static float pack(const float* b) { return b[0]; }
};
template <>
struct Lanes<2> {
  using type = float2;
  __device__ static void unpack(float2 v, float* b) {
    b[0] = v.x;
    b[1] = v.y;
  }
  __device__ static float2 pack(const float* b) {
    return make_float2(b[0], b[1]);
  }
};
template <>
struct Lanes<4> {
  using type = float4;
  __device__ static void unpack(float4 v, float* b) {
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
  }
  __device__ static float4 pack(const float* b) {
    return make_float4(b[0], b[1], b[2], b[3]);
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
dia_nmajor_kernel(const uint32_t* __restrict__ mask,
                  const float* __restrict__ x, float* __restrict__ y,
                  long long n, int L, const __grid_constant__ NMajorParams p) {
  using VT = typename Lanes<V>::type;
  const int G = L / V;           // lane groups a row
  const int runs = kThreads / G;  // row slots a sub-block
  const int t = threadIdx.x;
  const int run = t / G;
  if (run >= runs) return;
  const int lane = (t - run * G) * V;
  const long long cta0 =
      static_cast<long long>(blockIdx.x) * kSubBlocks * runs * kRows;
  for (int s = 0; s < kSubBlocks; ++s) {
    // the thread's rows: i0, i0 + runs, ..., i0 + (kRows - 1) runs
    const long long i0 = cta0 + static_cast<long long>(s) * runs * kRows + run;
    if (i0 >= n) return;
    uint32_t w[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long i = i0 + static_cast<long long>(q) * runs;
      w[q] = i < n ? __ldg(mask + i) : 0u;
    }
    float acc[kRows][V];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[q][e] = 0.0f;
    }
    for (int k = 0; k < p.K; ++k) {
      const long long j0 = i0 + p.offsets[k];
      float xv[kRows][V];
      if (j0 >= 0 && j0 + static_cast<long long>(kRows - 1) * runs < n) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const long long j = j0 + static_cast<long long>(q) * runs;
          Lanes<V>::unpack(
              __ldg(reinterpret_cast<const VT*>(x + j * L + lane)), xv[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const long long j = j0 + static_cast<long long>(q) * runs;
          if (j >= 0 && j < n) {
            Lanes<V>::unpack(
                __ldg(reinterpret_cast<const VT*>(x + j * L + lane)), xv[q]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[q][e] = 0.0f;
          }
        }
      }
      const float v = p.vals[k];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float c = ((w[q] >> k) & 1u) ? v : 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[q][e] = tps_rn::add(acc[q][e], tps_rn::mul(c, xv[q][e]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long i = i0 + static_cast<long long>(q) * runs;
      if (i < n) {
        *reinterpret_cast<VT*>(y + i * L + lane) = Lanes<V>::pack(acc[q]);
      }
    }
  }
}

template <int V>
int launch(const uint32_t* mask, const float* x, float* y, long long n,
           int L, const NMajorParams& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(kSubBlocks) *
                         (kThreads / (L / V)) * kRows;
  const long long ctas = (n + rows - 1) / rows;
  dia_nmajor_kernel<V><<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
      mask, x, y, n, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (n, L) = A @ x (n, L), both row-major, for the masked operand (mask
// (n,), K planes), float32, in lane groups of V (1, 2 or 4) values: L % V
// == 0 and x, y aligned to 4 V bytes (the wrapper picks V). offsets and
// vals are host arrays of K entries. Returns the cudaGetLastError() code
// after the launch, cudaErrorInvalidValue for another V or more than
// kThreads lane groups a row.
extern "C" int tps_dia_nmajor(const void* mask, const void* x, void* y,
                              long long n, int L, int V, int K,
                              const int* offsets, const float* vals,
                              void* stream) {
  if (K < 0 || K > kMaxPlanes || n < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || L == 0) return 0;
  if ((V != 1 && V != 2 && V != 4) || L % V != 0 || L / V > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NMajorParams p{};
  p.K = K;
  for (int k = 0; k < K; ++k) {
    p.offsets[k] = offsets[k];
    p.vals[k] = vals[k];
  }
  const auto* m = static_cast<const uint32_t*>(mask);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (V) {
    case 4:
      return launch<4>(m, xf, yf, n, L, p, s);
    case 2:
      return launch<2>(m, xf, yf, n, L, p, s);
    default:
      return launch<1>(m, xf, yf, n, L, p, s);
  }
}

// K7's geometry into out[4]: threads a CTA, rows a thread, sub-blocks a
// CTA, bytes of the widest lane group. Returns 0.
extern "C" int tps_dia_nmajor_geometry(int* out) {
  out[0] = kThreads;
  out[1] = kRows;
  out[2] = kSubBlocks;
  out[3] = kVectorBytes;
  return 0;
}
