// Shared helpers of the package's CUDA kernels: element types, launch
// plumbing. Each kernel file exposes extern "C" entry points that take raw
// pointers and a stream, launch, and return cudaGetLastError().
#pragma once

#include <atomic>

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

// Launch setup that holds per device. cudaFuncSetAttribute applies to the
// device that is current when it is called (the wrappers make the tensors'
// device current), so a kernel that needs more than 48 KB of dynamic shared
// memory opts in once on each device it launches on. One instance per
// kernel, as a function-local static: zero-initialised, so no device has
// opted in yet. Two threads that race set the same attribute twice, which
// is harmless.
constexpr int kMaxDevices = 64;

class PerDeviceSmem {
 public:
  cudaError_t opt_in(const void* kernel, int bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (done_[dev].load(std::memory_order_acquire)) return cudaSuccess;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) done_[dev].store(true, std::memory_order_release);
    return e;
  }

 private:
  std::atomic<bool> done_[kMaxDevices];
};

// The current device's number of SMs, read once per device (persistent
// grids are sized by it); 0 if it cannot be read, so that the launch sized
// by it is refused.
inline int sm_count() {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

}  // namespace yolo
