// Shared helpers for the port's CUDA kernels: dtype conversion to the f32
// the kernels accumulate in, the attention dropout hash, and the error
// string every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Attention-probability dropout mask: a pure function of (seed, stream,
// query row, key column), so the forward and backward kernels regenerate the
// same mask whatever their tiling, and ops/attention.py dropout_keep_mask
// reproduces it exactly. The stream of item b, head h is its global index
// (b + row_offset) * heads_total + h + head_offset (dropout_stream): a rank
// of a distributed step passes where its rows and heads lie in the global
// batch and draws its block of the one-process mask; (0, 0, H) give b*H + h.
// An element is kept iff its 32 bits >= threshold
// (threshold = min(floor(p * 2^32), 2^32 - 1)). Rows and columns < 2^16.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int dropout_stream(int b, int h, int row_offset, int head_offset,
                                              int heads_total) {
  return (b + row_offset) * heads_total + h + head_offset;
}

__device__ __forceinline__ uint32_t dropout_key(int seed, int bh) {
  return mix32(static_cast<uint32_t>(seed) ^
               mix32(static_cast<uint32_t>(bh) * 0x9e3779b9u + 0x632be5abu));
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, int row, int col) {
  return mix32(((static_cast<uint32_t>(row) << 16) | static_cast<uint32_t>(col)) ^ key);
}

}  // namespace fs2

#define FS2_EXPORT_ERROR_STRING                                  \
  extern "C" const char* error_string(int err) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(err));    \
  }
