// What the two attention sources (attention_fwd.cu, attention_bwd.cu) share:
// their argument structs, and the pre-pass each C entry launches before its
// kernel to find the key tiles the mask drops whole.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace fs2 {
namespace attn {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoKeyBias = -5e8f;  // a key is valid iff its bias is above this (NEG_INF / 2)

struct Strides {
  long long b, h, t;
};

struct Dropout {
  const int* seed;  // device scalar; unread when thresh == 0
  uint32_t thresh;
  float keep_scale;  // 1 / (1 - p)
  int row_offset, head_offset, heads_total;  // place (b, h) in the global batch

  // the hash key of item b, head h (common.cuh dropout_stream)
  __device__ __forceinline__ uint32_t key(int b, int h) const {
    return dropout_key(*seed, dropout_stream(b, h, row_offset, head_offset, heads_total));
  }
};

// kv_end[b] = one past item b's last key with bias > kNoKeyBias, or T when
// it has none (then every key takes part: the uniform average). The plain
// version is ops/attention.py kv_end. One block of 256 threads per item.
__global__ void __launch_bounds__(256) kv_end_kernel(const float* __restrict__ key_bias,
                                                     int T_len, int* __restrict__ kv_end) {
  __shared__ int warp_last[8];
  const float* row = key_bias + static_cast<long long>(blockIdx.x) * T_len;
  int last = 0;
  for (int t = threadIdx.x; t < T_len; t += 256)
    if (row[t] > kNoKeyBias) last = t + 1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0) warp_last[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < 8; ++w) last = max(last, warp_last[w]);
    kv_end[blockIdx.x] = last > 0 ? last : T_len;
  }
}

inline cudaError_t launch_kv_end(const float* key_bias, int B, int T_len, int* kv_end,
                                 cudaStream_t stream) {
  kv_end_kernel<<<B, 256, 0, stream>>>(key_bias, T_len, kv_end);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace fs2
