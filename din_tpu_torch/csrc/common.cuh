// Shared helpers for the hand-written Hopper kernels of din_tpu_torch.
//
// Every entry point has a plain C interface (no PyTorch headers), so the
// library builds with nvcc alone in seconds and is loaded with ctypes
// (din_tpu_torch/ops/native.py).  Each entry launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with din_tpu_torch/ops/native.py
enum DinDtype : int { DIN_F32 = 0, DIN_BF16 = 1 };

__device__ __forceinline__ float din_to_f32(float v) { return v; }
__device__ __forceinline__ float din_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T din_from_f32(float v);
template <>
__device__ __forceinline__ float din_from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 din_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// max that propagates NaN from either side, like torch.amax
__device__ __forceinline__ float din_nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
