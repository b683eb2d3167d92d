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
// 2 K L flops: far below the card's flop-per-byte balance. The design is
// simple first: a CTA owns kItems consecutive flat elements (rows_per_cta
// whole rows), stages their mask words once in shared memory so the L
// lanes of a row share one load, and walks the flat range with one thread
// per element, neighbouring threads on neighbouring elements, so every
// shifted read of x and the write of y are coalesced for any L. The K
// shifted reads of x hit L1/L2 after the first. The K offsets and
// coefficients travel by value in kernel parameters.

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kThreads = 256;
constexpr int kItems = 2048;  // flat elements per CTA: 8 per thread

struct NMajorParams {
  int offsets[kMaxPlanes];
  float vals[kMaxPlanes];
  int K;
};

__global__ void __launch_bounds__(kThreads)
dia_nmajor_kernel(const uint32_t* __restrict__ mask,
                  const float* __restrict__ x, float* __restrict__ y,
                  long long n, int L, int rows_per_cta, NMajorParams p) {
  __shared__ uint32_t s_mask[kItems];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long left = n - row0;
  const int rows = left < rows_per_cta ? static_cast<int>(left)
                                       : rows_per_cta;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    s_mask[r] = __ldg(mask + row0 + r);
  }
  __syncthreads();
  const long long base = row0 * L;
  const int items = rows * L;
  for (int t = threadIdx.x; t < items; t += kThreads) {
    const int r = t / L;
    const long long i = row0 + r;
    const uint32_t w = s_mask[r];
    float acc = 0.0f;
    for (int k = 0; k < p.K; ++k) {
      const long long j = i + p.offsets[k];
      const float xv =
          (j >= 0 && j < n)
              ? __ldg(x + base + t + static_cast<long long>(p.offsets[k]) * L)
              : 0.0f;
      const float c = ((w >> k) & 1u) ? p.vals[k] : 0.0f;
      acc = tps_rn::add(acc, tps_rn::mul(c, xv));
    }
    y[base + t] = acc;
  }
}

}  // namespace

// y (n, L) = A @ x (n, L), both row-major, for the masked operand (mask
// (n,), K planes), float32. offsets and vals are host arrays of K entries.
// Returns the cudaGetLastError() code after the launch.
extern "C" int tps_dia_nmajor(const void* mask, const void* x, void* y,
                              long long n, int L, int K, const int* offsets,
                              const float* vals, void* stream) {
  if (K < 0 || K > kMaxPlanes || n < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || L == 0) return 0;
  NMajorParams p{};
  p.K = K;
  for (int k = 0; k < K; ++k) {
    p.offsets[k] = offsets[k];
    p.vals[k] = vals[k];
  }
  const int rows_per_cta = L < kItems ? kItems / L : 1;
  const long long ctas = (n + rows_per_cta - 1) / rows_per_cta;
  dia_nmajor_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const float*>(x),
      static_cast<float*>(y), n, L, rows_per_cta, p);
  return static_cast<int>(cudaGetLastError());
}
