// Attention forward with an additive key bias and optional dropout on the
// attention probabilities, for the conformer's eval and training paths.
//
//   O = dropout_p(softmax(sm_scale * Q K^T + key_bias[b, None, :])) V
//   q, k, v, o: [B, H, T, dh] (any strides over B, H, T; dh contiguous)
//   key_bias:   [B, T] f32, 0 for a valid key and -1e9 for padding
//   lse:        optional [B, H, T] f32 output, m + log(l) per query row, for
//               the backward kernel (attention_bwd.cu)
//
// Dropout follows fastspeech2_lightning_tpu/ops/attention_dropout.py:264-273:
// the normalizer sums the UNMASKED exponentials, the numerator keeps only the
// kept entries, O = sum(keep * e * v) / ((1 - p) * sum(e)). keep iff the
// element's 32 hash bits >= thresh (common.cuh dropout_bits; thresh =
// min(floor(p * 2^32), 2^32 - 1), 0 at p = 0, where no bit is drawn and the
// result equals the dropout-free kernel bit for bit).
//
// Replaces three TPU kernels of the JAX package:
//   - the library Pallas flash_attention the eval conformer calls on TPU
//     (fastspeech2_lightning_tpu/models/conformer.py:142), whose segment ids
//     mask valid<->valid; on valid query rows the key-bias form is equal, and
//     padded rows are masked away downstream;
//   - fastspeech2_lightning_tpu/ops/attention_dropout.py:167
//     _attention_fwd_impl (_fwd_kernel :53), the full-row dropout forward;
//   - attention_dropout.py:461 _stream_fwd_impl (_sfwd_kernel :283), the
//     streaming dropout forward for T > 1536. One flash-style kernel covers
//     every T, so the TPU's full-row/streaming split has no counterpart.
// A row whose keys are all masked gets the uniform average, as the plain
// version (ops/attention.py attention_reference) does: -1e9 is a finite bias.
//
// Bound: 4*B*H*T^2*dh operations against 4*B*H*T*dh elements moved; at the
// decoder's training shape (B=16, H=2, T=2048, dh=128, bf16) that is 68.7
// GFLOP (about 69 us at the 989 TFLOP/s bf16 tensor-core peak) against
// 33.6 MB (about 10 us at 3.35 TB/s): compute-bound.
//
// Design (a simple first kernel): one block of 256 threads per
// (64-row query tile, head, batch), four threads per query row. The block
// keeps its Q tile in shared memory and walks the keys in 64-key tiles
// staged in shared memory, with an online softmax (f32 running max and sum
// per row, as _sfwd_kernel keeps them) and the [64, dh] output accumulator
// in registers. Scores never reach device memory. All arithmetic is f32 FMA
// on the CUDA cores: tensor cores (mma/wgmma), TMA and a pipelined ring of
// tiles are later work, so this kernel sits far from its bound.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per query row

struct Strides {
  long long b, h, t;
};

struct Dropout {
  const int* seed;  // device scalar; unread when thresh == 0
  uint32_t thresh;
  float keep_scale;  // 1 / (1 - p)
};

template <int DH>
constexpr size_t smem_floats() {
  // Q and K tiles padded to DH + 1 columns (conflict-free column reads),
  // V tile, probability tile padded to BK + 1, key bias.
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1) + BK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ key_bias,
                     T* __restrict__ o, float* __restrict__ lse, int T_len,
                     Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
                     Dropout drop) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1;
  constexpr int LP = BK + 1;
  constexpr int NO = DH / 4;   // output columns per thread
  constexpr int NS = BK / 4;   // score columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * DH;
  float* Bs = Ps + BQ * LP;

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int part = tid & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const uint32_t key = drop.thresh ? fs2::dropout_key(*drop.seed, b * gridDim.y + h) : 0u;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, t = q0 + r;
    Qs[r * LD + d] = t < T_len ? fs2::to_f32(qb[t * qs.t + d]) : 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int m = 0; m < NO; ++m) acc[m] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Q is in place
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, t = k0 + r;
      const bool ok = t < T_len;
      Ks[r * LD + d] = ok ? fs2::to_f32(kb[t * ks.t + d]) : 0.f;
      Vs[r * DH + d] = ok ? fs2::to_f32(vb[t * vs.t + d]) : 0.f;
    }
    if (tid < BK) {
      const int t = k0 + tid;
      // keys past the end take no part at all (-inf), unlike masked keys
      Bs[tid] = t < T_len ? biasb[t] : -INFINITY;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    const float* qrow = Qs + row * LD;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = fmaf(qv, Ks[(part + 4 * j) * LD + d], s[j]);
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float bias = Bs[part + 4 * j];
      s[j] = bias == -INFINITY ? -INFINITY : s[j] * sm_scale + bias;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every tile holds at least one key inside [0, T), so m_new is finite
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      float kept = p;
      if (drop.thresh && fs2::dropout_bits(key, q0 + row, k0 + part + 4 * j) < drop.thresh)
        kept = 0.f;
      Ps[row * LP + part + 4 * j] = kept;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int m = 0; m < NO; ++m) acc[m] *= alpha;
    __syncthreads();  // the row's probabilities are in Ps

    const float* prow = Ps + row * LP;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * DH + part;
#pragma unroll
      for (int m = 0; m < NO; ++m) acc[m] = fmaf(p, vrow[4 * m], acc[m]);
    }
  }

  const int t = q0 + row;
  if (t < T_len) {
    const float inv = (1.f / l_run) * drop.keep_scale;
    T* orow = o + b * os.b + h * os.h + t * os.t + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) orow[4 * m] = fs2::from_f32<T>(acc[m] * inv);
    if (lse != nullptr && part == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * T_len + t] = m_run + logf(l_run);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* o, float* lse, int B, int H, int T_len, Strides qs, Strides ks,
                   Strides vs, Strides os, float sm_scale, Dropout drop,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(o), lse, T_len, qs, ks, vs, os,
      sm_scale, drop);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// Strides are in elements. `lse` may be null (no log-sum-exp output);
// `seed` may be null when thresh == 0. Returns a cudaError_t code (0 on
// success).
extern "C" int attention_fwd(int dtype, const void* q, const void* k, const void* v,
                             const void* key_bias, void* o, void* lse, const void* seed,
                             int B, int H, int T_len, int dh,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long o_sb, long long o_sh, long long o_st,
                             float sm_scale, long long thresh, float keep_scale,
                             void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > 65536 || thresh < 0 || thresh > 0xffffffffLL ||
      (thresh > 0 && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale};
  float* l = static_cast<float*>(lse);
  if (dtype == fs2::kFloat32 && dh == 64)
    return launch<float, 64>(q, k, v, key_bias, o, l, B, H, T_len, qs, ks, vs, os, sm_scale,
                             drop, st);
  if (dtype == fs2::kFloat32 && dh == 128)
    return launch<float, 128>(q, k, v, key_bias, o, l, B, H, T_len, qs, ks, vs, os, sm_scale,
                              drop, st);
  if (dtype == fs2::kBFloat16 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, key_bias, o, l, B, H, T_len, qs, ks, vs, os,
                                     sm_scale, drop, st);
  if (dtype == fs2::kBFloat16 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, key_bias, o, l, B, H, T_len, qs, ks, vs, os,
                                      sm_scale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
