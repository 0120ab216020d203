// Shared helpers of the package's CUDA kernels: element types, launch
// plumbing. Each kernel file exposes extern "C" entry points that take raw
// pointers and a stream, launch, and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace yolo {

// dtype codes passed from Python (ops/kernels/*.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// SiLU in f32, the formula of jax.nn.silu / torch.nn.functional.silu
__device__ __forceinline__ float silu(float y) {
  return y / (1.0f + expf(-y));
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace yolo
