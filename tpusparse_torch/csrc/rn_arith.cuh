// Round-to-nearest products and sums for the kernels' scalar types.
//
// Every kernel of the port rounds a product and a sum separately, in a
// fixed order, as its plain PyTorch version does. nvcc contracts
// a * b + c into one fused multiply-add by default, so the kernels spell
// the rounding out with the intrinsics; K8, which accumulates in fused
// multiply-adds, spells those out too. One overload per scalar type lets
// one template serve a float32 kernel and its float64 twin (K1-K5 and
// K1d-K5d, K8 and K8d).

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each translation unit that includes this header gets
// its own copy.
namespace tps_rn {
namespace {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
// a * b + c rounded once (K8's fused accumulation).
__device__ __forceinline__ float fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

}  // namespace
}  // namespace tps_rn
