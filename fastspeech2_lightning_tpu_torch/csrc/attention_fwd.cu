// Attention forward with an additive key bias and optional dropout on the
// attention probabilities, for the conformer's eval and training paths.
//
//   O = dropout_p(softmax(sm_scale * Q K^T + key_bias[b, None, :])) V
//   q, k, v, o: [B, H, T, dh] (any strides over B, H, T; dh contiguous)
//   key_bias:   [B, T] f32, 0 for a valid key and -1e9 for padding
//   kv_end:     [B] int32, one past each item's last key with bias > -5e8
//               (T for an item with no such key), which a pre-pass kernel
//               of the same C entry computes; key tiles at or past it are
//               skipped, which is exact: their exponentials are 0 in f32
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
// version (ops/attention.py attention_reference) does: -1e9 is a finite bias,
// and such an item keeps every key tile (kv_end = T).
//
// Bound: 4*H*T*dh operations per key the mask keeps and query row, against
// 4*B*H*T*dh elements moved; at the decoder's training shape (B=16, H=2,
// T=2048, dh=128, bf16) 68.7 GFLOP with every key, about 69 us at the
// 989 TFLOP/s bf16 tensor-core peak, against 33.6 MB (about 10 us at
// 3.35 TB/s): compute-bound.
//
// Two kernels; the dtype picks one (not a fallback):
//
// bf16 (attention_fwd_tc): Hopper warpgroup products. One block of one
// warpgroup (4 warps, 16 query rows each) per (64-row query tile, head,
// batch), two blocks per SM. K and V tiles of 64 keys (and their bias)
// stream through a two-stage cp.async ring in shared memory, stored in the
// 128-byte-swizzled layout that wgmma descriptors name (tensor_core.cuh);
// the Q tile stays there. Per key tile the warpgroup computes
// S = Q K^T with wgmma.m64n64k16 (both operands from shared memory, bf16 in,
// f32 out), runs the online softmax and the dropout hash on the f32
// accumulators in registers (the (row, col) of each register follows from
// the fragment layout), rounds the kept unnormalized exponentials to bf16 as
// the JAX kernel does (attention_dropout.py:68), and feeds them from
// registers as the A operand of O += P V (wgmma.m64n{dh}k16, V read from
// shared memory through the transpose flag). The key loop stops at
// ceil(kv_end[b] / 64).
// What limits it: within a block the products and the softmax run one after
// the other (the second block on the SM overlaps them), and with dropout the
// hash costs about 10 integer operations per score. A producer warp with
// TMA, and two consumer warpgroups taking turns, are the next steps.
//
// f32 (attention_fwd_f32): the CUDA-core kernel the f32 card-vs-CPU checks
// use (rel-L2 1e-5, which TF32 tensor cores would not meet): one block of
// 256 threads per (64-row query tile, head, batch), four threads per query
// row, 64-key tiles staged in shared memory, f32 FMA throughout, the same
// online softmax and the same kv_end bound.

#include <math.h>

#include "attention_common.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using fs2::attn::Dropout;
using fs2::attn::kLog2e;
using fs2::attn::Strides;
using fs2::tc::bf16;

// -- bf16: tensor cores -------------------------------------------------------

namespace tc_fwd {

constexpr int BQ = 64;        // query rows per block: one warpgroup
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows; two blocks per SM

template <int DH>
constexpr size_t smem_bytes() {
  // 1024 bytes to align the tiles to the swizzle period, the Q tile, two
  // stages of K and V tiles (bf16), two stages of key bias
  return 1024 + (BQ * DH + 4 * BK * DH) * sizeof(bf16) + 2 * BK * sizeof(float);
}

}  // namespace tc_fwd

template <int DH, bool DROP>
__global__ void __launch_bounds__(tc_fwd::THREADS, 2)
attention_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ key_bias,
                 const int* __restrict__ kv_end, bf16* __restrict__ o,
                 float* __restrict__ lse, int T_len, Strides qs, Strides ks, Strides vs,
                 Strides os, float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using namespace tc_fwd;
  constexpr int KSTEPS = DH / 16;  // k-steps of S = Q K^T
  constexpr int NB_S = BK / 8;     // n-blocks of S
  constexpr int NB_O = DH / 8;     // n-blocks of O
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* Ks = Qs + BQ * DH;      // [2][BK * DH]
  bf16* Vs = Ks + 2 * BK * DH;  // [2][BK * DH]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * DH);  // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;
  const int n_tiles = (min(max(kv_end[b], 1), T_len) + BK - 1) / BK;

  auto load_kv = [&](int stage, int k0) {
    load_tile<BK, DH, THREADS>(Ks + stage * BK * DH, kb, ks.t, k0, T_len, tid);
    load_tile<BK, DH, THREADS>(Vs + stage * BK * DH, vb, vs.t, k0, T_len, tid);
    if (tid < BK) {
      const bool ok = k0 + tid < T_len;
      cp_async4(Bs + stage * BK + tid, biasb + (ok ? k0 + tid : 0), ok);
    }
  };

  load_tile<BQ, DH, THREADS>(Qs, qb, qs.t, q0, T_len, tid);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows and their dropout hash prefixes
  const int row0 = q0 + warp * 16 + g;
  uint32_t rk[2] = {0u, 0u};
  if (DROP) {
    const uint32_t key = drop.key(b, h);
    rk[0] = (static_cast<uint32_t>(row0) << 16) ^ key;
    rk[1] = (static_cast<uint32_t>(row0 + 8) << 16) ^ key;
  }

  float acc[NB_O][4];
#pragma unroll
  for (int n = 0; n < NB_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums; the quad's sum at the end

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, (j + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) landed
    fence_async_shared();
    __syncthreads();
    const bf16* Kt = Ks + (j & 1) * BK * DH;
    const bf16* Vt = Vs + (j & 1) * BK * DH;
    const float* Bt = Bs + (j & 1) * BK;
    const int k0 = j * BK;

    // S = Q K^T: one warpgroup product per 16-wide k-step, both from shared memory
    float s[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = (kk & 3) * 16;  // within the 64-wide column block kk / 4
      wgmma_ss_n64(s, sw128_desc(Qs + (kk >> 2) * BQ * 64 + col, 16, 1024),
                   sw128_desc(Kt + (kk >> 2) * BK * 64 + col, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();

    // scaled, biased scores; keys past T (in the last tile only) take no
    // part at all (-inf)
    const bool tail = k0 + BK > T_len;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        float x = fmaf(s[n][e], sm_scale, Bt[c]);
        if (tail && k0 + c >= T_len) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a key inside [0, T), so the new max is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = fast_exp2((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fast_exp2((s[n][e] - m_run[r]) * kLog2e);
        l_run[r] += p;
        if (DROP) {
          const uint32_t col = static_cast<uint32_t>(k0 + n * 8 + 2 * t4 + (e & 1));
          if (fs2::mix32(rk[r] ^ col) < drop.thresh) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    // once the row maxima settle, alpha is 1 for the whole warp: skip
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NB_O; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // O += P V: P (kept, unnormalized, bf16) from registers, V from shared
    // memory read transposed
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = sw128_desc(Vt + kk * 16 * 64, BK * 128, 1024);
      if constexpr (DH == 128)
        wgmma_rs_n128(acc, pa[kk], vd);
      else
        wgmma_rs_n64(acc, pa[kk], vd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // stage j & 1 is consumed before tile j + 2 refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int t = row0 + 8 * r;
    if (t >= T_len) continue;
    const float inv = drop.keep_scale / l_run[r];
    bf16* orow = o + b * os.b + h * os.h + t * os.t + 2 * t4;
#pragma unroll
    for (int n = 0; n < NB_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * T_len + t] = m_run[r] + logf(l_run[r]);
  }
}

// -- f32: CUDA cores ----------------------------------------------------------

namespace f32_fwd {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per query row

template <int DH>
constexpr size_t smem_floats() {
  // Q and K tiles padded to DH + 1 columns (conflict-free column reads),
  // V tile, probability tile padded to BK + 1, key bias.
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1) + BK;
}

}  // namespace f32_fwd

template <int DH>
__global__ void __launch_bounds__(f32_fwd::THREADS)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ key_bias,
                  const int* __restrict__ kv_end, float* __restrict__ o,
                  float* __restrict__ lse, int T_len, Strides qs, Strides ks, Strides vs,
                  Strides os, float sm_scale, Dropout drop) {
  using namespace f32_fwd;
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
  const uint32_t key = drop.thresh ? drop.key(b, h) : 0u;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;
  const int k_end = min(max(kv_end[b], 1), T_len);

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, t = q0 + r;
    Qs[r * LD + d] = t < T_len ? qb[t * qs.t + d] : 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int m = 0; m < NO; ++m) acc[m] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Q is in place
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, t = k0 + r;
      const bool ok = t < T_len;
      Ks[r * LD + d] = ok ? kb[t * ks.t + d] : 0.f;
      Vs[r * DH + d] = ok ? vb[t * vs.t + d] : 0.f;
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
    float* orow = o + b * os.b + h * os.h + t * os.t + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) orow[4 * m] = acc[m] * inv;
    if (lse != nullptr && part == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * T_len + t] = m_run + logf(l_run);
  }
}

// -- launch -------------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* kv_end, void* o, float* lse, int B, int H, int T_len,
                       Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
                       Dropout drop, cudaStream_t stream) {
  using namespace f32_fwd;
  const size_t smem = smem_floats<DH>() * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per process
      attention_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  attention_fwd_f32<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, kv_end, static_cast<float*>(o), lse, T_len, qs, ks, vs, os, sm_scale, drop);
  return cudaGetLastError();
}

template <int DH, bool DROP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* bias,
                      const int* kv_end, void* o, float* lse, int B, int H, int T_len,
                      Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
                      Dropout drop, cudaStream_t stream) {
  using namespace tc_fwd;
  const size_t smem = smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per process
      attention_fwd_tc<DH, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  attention_fwd_tc<DH, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, kv_end, static_cast<bf16*>(o), lse, T_len, qs, ks, vs, os, sm_scale, drop);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// Strides are in elements; for bf16 every row of q, k, v starts on 16 bytes
// (the wrapper checks). `kv_end` is [B] int32 scratch: a pre-pass kernel on
// the same stream fills it (attention_common.cuh) and the attention kernel
// reads it. `lse` may be null (no log-sum-exp output); `seed` may be null
// when thresh == 0. Returns a cudaError_t code (0 on success).
extern "C" int attention_fwd(int dtype, const void* q, const void* k, const void* v,
                             const void* key_bias, void* kv_end, void* o, void* lse,
                             const void* seed, int B, int H, int T_len, int dh,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long o_sb, long long o_sh, long long o_st,
                             float sm_scale, long long thresh, float keep_scale,
                             int row_offset, int head_offset, int heads_total,
                             void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > 65536 || thresh < 0 || thresh > 0xffffffffLL ||
      (thresh > 0 && seed == nullptr) || kv_end == nullptr || row_offset < 0 ||
      head_offset < 0 || head_offset + H > heads_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale,
                     row_offset, head_offset, heads_total};
  const float* bias = static_cast<const float*>(key_bias);
  int* kend = static_cast<int*>(kv_end);
  float* l = static_cast<float*>(lse);
  const bool dropout = thresh > 0;
  if ((dtype != fs2::kFloat32 && dtype != fs2::kBFloat16) || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = fs2::attn::launch_kv_end(bias, B, T_len, kend, st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define FS2_FWD_ARGS q, k, v, bias, kend, o, l, B, H, T_len, qs, ks, vs, os, sm_scale, drop, st
  if (dtype == fs2::kFloat32 && dh == 64) return launch_f32<64>(FS2_FWD_ARGS);
  if (dtype == fs2::kFloat32 && dh == 128) return launch_f32<128>(FS2_FWD_ARGS);
  if (dtype == fs2::kBFloat16 && dh == 64)
    return dropout ? launch_tc<64, true>(FS2_FWD_ARGS) : launch_tc<64, false>(FS2_FWD_ARGS);
  if (dtype == fs2::kBFloat16 && dh == 128)
    return dropout ? launch_tc<128, true>(FS2_FWD_ARGS) : launch_tc<128, false>(FS2_FWD_ARGS);
#undef FS2_FWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
