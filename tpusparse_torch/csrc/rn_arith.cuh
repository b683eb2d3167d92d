// Round-to-nearest products and sums for the kernels' scalar types.
//
// Every kernel of the port rounds a product and a sum separately, in a
// fixed order, as its plain PyTorch version does. nvcc contracts
// a * b + c into one fused multiply-add by default, so the kernels spell
// the rounding out with the intrinsics. One overload per scalar type lets
// one template serve float32 (K1-K5) and float64 (their twins K1d-K5d).

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

}  // namespace
}  // namespace tps_rn
