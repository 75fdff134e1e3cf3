// Shared helpers for the port's CUDA kernels: dtype conversion to the f32
// the kernels accumulate in, and the error string every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fs2 {

// dtype codes passed from Python (see ops/*.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace fs2

#define FS2_EXPORT_ERROR_STRING                                  \
  extern "C" const char* error_string(int err) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(err));    \
  }
