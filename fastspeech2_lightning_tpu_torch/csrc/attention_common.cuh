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

// the head dims the kernels are built for; ops/attention.py pads every
// other dh up to 256 to the next of them with zero columns
__host__ __device__ constexpr bool built_dh(int dh) {
  return dh == 64 || dh == 128 || dh == 192 || dh == 256;
}

// Head dims above 256 run at a multiple of 128 (ops/attention.py pads to
// it, as the JAX package pads every dh). The kernels stream the products
// over dh (S = Q K^T, and in the backward also dP = dO V^T) through shared
// memory in CHUNK-wide column chunks. A block takes group_width() output
// columns; where that is less than dh, every group recomputes the streamed
// products.
constexpr int CHUNK = 64;
constexpr int kSplitFwdMaxDh = 768;  // the widest dh of attention_fwd_tc_split

__host__ __device__ constexpr bool wide_dh(int dh) { return dh > 256 && dh % 128 == 0; }

// the output columns a block of a wide head dim takes: the bf16 forward
// the whole dh up to kSplitFwdMaxDh (its two warpgroups split the columns;
// each score once); above, and in the bf16 backward, 256 where they divide
// dh (the accumulators of the dh-256 kernels); in the backward, else 192
// where they divide dh (each warpgroup 96 columns, as in the dh-192
// backward); else 128; the f32 CUDA-core kernels take 128
__host__ __device__ constexpr int group_width(bool bf16, int dh, bool backward = false) {
  if (!bf16) return 128;
  if (!backward && dh <= kSplitFwdMaxDh) return dh;
  if (dh % 256 == 0) return 256;
  return backward && dh % 192 == 0 ? 192 : 128;
}

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
