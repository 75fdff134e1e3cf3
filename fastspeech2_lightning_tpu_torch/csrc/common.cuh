// Shared helpers for the port's CUDA kernels: dtype conversion to the f32
// the kernels accumulate in, the attention dropout hash, the per-device
// shared-memory opt-in, and the error string every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
// (threshold = min(floor(p * 2^32), 2^32 - 1)).
//
// The bits of (row, col): mix32 of the low 16 bits of each packed into one
// word, xor the key, xor dropout_high, a mix of their high 16 bits. Since
// mix32(0) == 0, dropout_high is 0 while row and col are below 2^16, so a
// mask at T <= 65536 is the one the low packing alone drew; past it every
// (row, col) below 2^32 keeps a word of its own. A tile of 16 or more rows
// or columns aligned to its size never crosses a multiple of 2^16, so the
// kernels that keep `(row << 16) ^ key` a row add dropout_high once a tile
// and the low 16 bits of the column an element.

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

// what rows and columns of 2^16 or more add to the hash: 0 below
__device__ __forceinline__ uint32_t dropout_high(int row, int col) {
  return mix32(((static_cast<uint32_t>(row) >> 16) << 16) | (static_cast<uint32_t>(col) >> 16));
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, int row, int col) {
  return mix32(((static_cast<uint32_t>(row) << 16) | (static_cast<uint32_t>(col) & 0xffffu)) ^
               key ^ dropout_high(row, col));
}

// The max-dynamic-shared-memory opt-in (cudaFuncSetAttribute) is an
// attribute of a kernel in the current device's context, not of the
// process: a process that launches on a second card must set it there too,
// or the first launch that needs more than 48 KiB fails. Each launch site
// keeps a static SmemOptIn and sets the attribute the first time it
// launches on a device (two threads that race there set it twice, which is
// harmless).
constexpr int kMaxDevices = 64;

struct SmemOptIn {
  std::atomic<int> state[kMaxDevices];  // 0: not set yet; else 1 + what it returned
};

template <typename Kernel>
inline cudaError_t smem_opt_in(SmemOptIn& once, Kernel kernel, int bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int s = once.state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    s = 1 + static_cast<int>(
                cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    once.state[dev].store(s, std::memory_order_release);
  }
  return static_cast<cudaError_t>(s - 1);
}

}  // namespace fs2

#define FS2_EXPORT_ERROR_STRING                                  \
  extern "C" const char* error_string(int err) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(err));    \
  }
