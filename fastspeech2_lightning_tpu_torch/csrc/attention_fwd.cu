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
// 3.35 TB/s): compute-bound. What limits the bf16 kernels on the card is
// neither: each block streams the K and V tiles of its (b, h) from L2, and
// the bytes every design here moves that way, over its time, come to about
// 3.0-3.3 TB/s (PERF.md), so a kernel's time follows the K and V
// bytes it loads per query row.
//
// The dtype and dh pick one of five kernels (not a fallback):
//
// bf16, dh 64 and 128 (attention_fwd_tc): Hopper warpgroup products. One
// block of one warpgroup (4 warps, 16 query rows each) per (64-row query
// tile, head, batch), two blocks per SM. K and V tiles of 64 keys (and
// their bias) stream through a two-stage cp.async ring in shared memory,
// stored in the 128-byte-swizzled layout that wgmma descriptors name
// (tensor_core.cuh); the Q tile stays there. Per key tile the warpgroup
// computes S = Q K^T with wgmma.m64n64k16 (both operands from shared
// memory, bf16 in, f32 out), runs the online softmax and the dropout hash on
// the f32 accumulators in registers (softmax_tile; the (row, col) of each
// register follows from the fragment layout), rounds the kept unnormalized
// exponentials to bf16 as the JAX kernel does (attention_dropout.py:68), and
// feeds them from registers as the A operand of O += P V (wgmma.m64n{dh}k16,
// V read from shared memory through the transpose flag). The key loop stops
// at ceil(kv_end[b] / 64). Within a block the products and the softmax run
// one after the other; the second block on the SM overlaps them.
//
// bf16, dh 192 and 256 (attention_fwd_tc_pair; the wrapper zero-pads every
// dh from 129 to 256 to one of them): one block of two warpgroups per
// (128-row query tile, head, batch), so each K and V tile loaded serves 128
// query rows, half the bytes a query row of a block of one warpgroup on 64
// rows (which took one SM alone at these dh). Q (128 rows)
// and S-stage rings of K and V tiles (S = 3 at 192, 2 at 256: 194 KB of
// shared memory either way) arrive by TMA (cp.async.bulk.tensor from 4-D
// tensor maps the host encodes per launch, 128-byte swizzle, rows past T
// zero-filled), each completing on an mbarrier; each tile's key bias (-inf
// past T) goes beside K into a ring of 2 S slots, written by one warp. Per
// key tile j a warpgroup issues O += P_{j-1} V_{j-1} and S_j = Q K_j^T as one
// group of products, then runs S_j's softmax and hash while the other
// warpgroup's products run: named barriers 1 and 2 make the two take turns
// at issuing. There is no producer warp: once a warpgroup's group is done
// (named barrier 3 or 4 over its warps), K_j's and V_{j-1}'s stages are free
// in it, and the second of the two warpgroups to get there (a shared-memory
// counter) refills them with K_{j+S} and V_{j-1+S}, its warp 0 writing the
// bias and one lane starting the copies; the bias of tile j + S is read from
// device memory while that group's products run. Registers (nvcc 12.9,
// -Xptxas -v): 189 at dh 192 and 223 with dropout, 228 and 243 at 256; no
// spill. A producer warp would cap every thread at 224 registers (288
// threads; setmaxnreg needs a whole producer warpgroup, which leaves 168
// before the exchange), and a refill issued after both warpgroups release
// a stage starts no sooner from a producer. Taking the turns out costs
// 1-4 % (tools/fwd_pair_turns.py). Not tried: issuing S_{j+1} before S_j's
// softmax within a warpgroup, which holds 32 more accumulators a thread
// (dh 256 already takes 228-243 registers), where the K and V bytes, not
// the order of issue, set the time.
//
// bf16 above dh 256 (attention_fwd_tc_split; attention_common.cuh wide_dh
// and group_width: every multiple of 128 up to 768, the wrapper padding
// 257-384 to 384 and so on, as the JAX package pads dh to a multiple of
// 128): a 64-row Q tile and 64 keys of the full dh fit neither shared
// memory nor registers together, so one block of two warpgroups per
// (64-row query tile, head, batch) splits the tile's work between them:
// warpgroup w owns output columns [w dh/2, (w + 1) dh/2) (96 to 192
// accumulators a thread) and keys [32 w, 32 w + 32) of each key tile. It
// computes S for its 32 keys over the full dh (wgmma.m64n32k16, Q resident
// in shared memory, K streaming by TMA in 64-wide column chunks through a
// KS-stage ring, a __syncthreads a chunk to release its stage), the scaled,
// biased scores and their row maxima, which the two exchange through shared
// memory (both take the same new maximum, bit for bit), then the
// exponentials, its partial row sums and the hash, and writes keep * P as
// bf16 into a shared [query][key] tile; after a barrier, O += P V on its
// own columns, P and the V tile (by TMA in a VS-stage ring) both from
// shared memory (m64n128 products, and an m64n64 where dh/2 is an odd
// multiple of 64). Each score, exponential, hash and product is issued once
// (column groups that each recompute S, as above dh 768, issue 2x the
// function's operations at dh 384 and 768 in groups of 128 and 256, 1.5x
// at 512). The partial row
// sums meet at the end; warpgroup 0 writes the log-sum-exp. The rings take
// what 227 KB leaves beside Q and P (tc_split k_stages, v_stages): (VS, KS)
// (2, 9) at dh 384, (1, 11) at 512, (1, 7) at 640, (1, 3) at 768; two K
// chunks at 512 (one load in flight) left the S phase waiting on L2 (0.2645
// against 0.1778 ms at (16, 1, 1024, 512), PERF.md). Registers: 142-168 at
// 384, 174-198 at 512, 206-231 at 640, 237-255 at 768; no spill.
//
// bf16 above dh 768 (attention_fwd_tc_wide): a block takes one group of NG
// output columns (256 where 256 divides dh, else 128), blockIdx.x = query
// tile * groups + group, and streams S = Q K^T over the full dh in 64-wide
// chunks of the Q and K tiles (a two-stage cp.async ring) into the same
// registers, then softmax_tile and P V on the group's columns of V. Every
// group recomputes S, the row statistics and the mask (a function of (seed,
// stream, row, col) alone), so the groups agree on them bit for bit; group
// 0 writes the log-sum-exp. A forward issues groups x 2 T^2 dh + 2 T^2 dh
// operations a (b, h) for the function's 4 T^2 dh (2.5x at dh 1024 in 4
// groups of 256, 4x at 896 in 7 of 128). At NG 256 the 128 accumulators a
// thread and the chunk loop's addresses spill (nvcc 12.9, -Xptxas -v: 140
// bytes stored and 124 loaded, 160 and 168 with dropout, at 255 registers);
// NG 128 does not spill (212 and 226 registers).
//
// f32 (attention_fwd_f32, attention_fwd_f32_wide): the CUDA-core kernels the
// f32 card-vs-CPU checks use (rel-L2 1e-5, which TF32 tensor cores would
// not meet): one block of 256 threads per (64-row query tile, head, batch),
// four threads per query row, 64-key tiles staged in shared memory, f32 FMA
// throughout, the same online softmax and the same kv_end bound; at dh 256
// its tiles take 214 KB. Above 256, one group of 128 output columns a
// block, S summed over dh in 64-wide chunks, recomputed in every group.
//
// T: a block's rows and keys are ints, and the dropout hash keys on the
// full (row, col) (common.cuh dropout_bits), so T is not bounded at any p.

#include <cuda.h>
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

// a wide head dim: two stages of (Q chunk, K chunk), two stages of the V
// tile's NG group columns (bf16), two stages of key bias
template <int NG>
constexpr size_t wide_smem_bytes() {
  constexpr int CW = fs2::attn::CHUNK;
  return 1024 + (2 * (BQ + BK) * CW + 2 * BK * NG) * sizeof(bf16) + 2 * BK * sizeof(float);
}

}  // namespace tc_fwd

// One key tile's online softmax once S = Q K^T is in `s`: scale and bias
// the scores (`Bt`: the tile's key bias), update the row maxima and sums,
// rescale the NO columns of `acc` by the change of the maxima, draw the
// dropout hash, and leave the kept unnormalized exponentials, rounded to
// bf16, in `pa`: the A fragments of O += P V.
template <int NO, bool DROP>
__device__ __forceinline__ void softmax_tile(float (&s)[tc_fwd::BK / 8][4],
                                             float (&acc)[NO / 8][4], float (&m_run)[2],
                                             float (&l_run)[2],
                                             uint32_t (&pa)[tc_fwd::BK / 16][4],
                                             const float* Bt, int k0, int T_len,
                                             float sm_scale, const uint32_t (&rk)[2],
                                             int row0, uint32_t thresh, int t4) {
  using namespace fs2::tc;
  constexpr int BK = tc_fwd::BK;
  constexpr int NB_S = BK / 8;  // n-blocks of S
  constexpr int NB_O = NO / 8;  // n-blocks of O
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
  // the tile's part of the dropout hash (common.cuh dropout_bits): the high
  // halves of its rows and keys, and the low half of its first key
  const uint32_t hk = DROP ? fs2::dropout_high(row0, k0) : 0u;
  const uint32_t rkt[2] = {rk[0] ^ hk, rk[1] ^ hk};
  const uint32_t c_lo = static_cast<uint32_t>(k0) & 0xffffu;
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
        const uint32_t col = c_lo + static_cast<uint32_t>(n * 8 + 2 * t4 + (e & 1));
        if (fs2::mix32(rkt[r] ^ col) < thresh) p = 0.f;
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
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
}

// O += P V for the NO columns of the V tile `Vt` (BK rows, its 64-wide
// column blocks BK * 64 apart), P from registers, V read transposed;
// issued and committed, not waited for
template <int NO>
__device__ __forceinline__ void issue_pv(float (&acc)[NO / 8][4],
                                         const uint32_t (&pa)[tc_fwd::BK / 16][4],
                                         const bf16* Vt) {
  using namespace fs2::tc;
#pragma unroll
  for (int kk = 0; kk < tc_fwd::BK / 16; ++kk)
    wgmma_rs_cols<NO, tc_fwd::BK>(acc, pa[kk], Vt + kk * 16 * 64);
}

// One key tile of the one-warpgroup forward once S is in `s`: the softmax,
// then O += P V, waited for.
template <int NO, bool DROP>
__device__ __forceinline__ void softmax_pv_tile(float (&s)[tc_fwd::BK / 8][4],
                                                float (&acc)[NO / 8][4], float (&m_run)[2],
                                                float (&l_run)[2], const float* Bt,
                                                const bf16* Vt, int k0, int T_len,
                                                float sm_scale, const uint32_t (&rk)[2],
                                                int row0, uint32_t thresh, int t4) {
  using namespace fs2::tc;
  uint32_t pa[tc_fwd::BK / 16][4];
  softmax_tile<NO, DROP>(s, acc, m_run, l_run, pa, Bt, k0, T_len, sm_scale, rk, row0, thresh,
                         t4);
  wgmma_fence();
  issue_pv<NO>(acc, pa, Vt);
  wgmma_commit();
  wgmma_wait<0>();
}

// The bf16 forward's epilogue: O / l (times 1 / (1 - p)) for this thread's
// two rows, at output columns col0 + .., and (with_lse) the rows'
// log-sum-exp.
template <int NO>
__device__ __forceinline__ void store_rows(float (&acc)[NO / 8][4], const float (&m_run)[2],
                                           float (&l_run)[2], bf16* o, float* lse, int b,
                                           int h, int row0, int col0, int T_len, Strides os,
                                           float keep_scale, bool with_lse, int t4) {
  using namespace fs2::tc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int t = row0 + 8 * r;
    if (t >= T_len) continue;
    const float inv = keep_scale / l_run[r];
    bf16* orow = o + b * os.b + h * os.h + t * os.t + col0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (with_lse && t4 == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * T_len + t] = m_run[r] + logf(l_run[r]);
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(tc_fwd::THREADS, 2)
attention_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ key_bias,
                 const int* __restrict__ kv_end, bf16* __restrict__ o,
                 float* __restrict__ lse, int T_len, Strides qs, Strides ks, Strides vs,
                 Strides os, float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using namespace tc_fwd;
  static_assert(DH == 64 || DH == 128, "dh 64 and 128; above, attention_fwd_tc_pair");
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

    softmax_pv_tile<DH, DROP>(s, acc, m_run, l_run, Bt, Vt, k0, T_len, sm_scale, rk, row0,
                              drop.thresh, t4);
    __syncthreads();  // stage j & 1 is consumed before tile j + 2 refills it
  }

  store_rows<DH>(acc, m_run, l_run, o, lse, b, h, row0, 0, T_len, os, drop.keep_scale,
                 lse != nullptr, t4);
}

// -- bf16, dh 192 and 256: two warpgroups on shared K and V tiles -------------

namespace tc_pair {

constexpr int BQ = 128;             // query rows a block: two warpgroups of 64
constexpr int BK = tc_fwd::BK;      // keys a tile, as softmax_tile takes them
constexpr int THREADS = 256;        // one block an SM

// Whether the two warpgroups take turns at issuing products (named barriers
// 1 and 2). On unless the source is built with -DFS2T_PAIR_TURNS=0, as
// tools/fwd_pair_turns.py builds it to time the kernel without the turns
// (both builds compute the same values bit for bit).
#ifndef FS2T_PAIR_TURNS
#define FS2T_PAIR_TURNS 1
#endif
constexpr bool TURNS = FS2T_PAIR_TURNS != 0;

// stages of the K and V rings: three at dh 192, two at 256 (what the 227 KB
// a block may opt into holds beside the 128-row Q tile)
template <int DH>
constexpr int stages() {
  return DH <= 192 ? 3 : 2;
}

// byte offsets in shared memory from its first 1024-byte boundary
template <int DH>
struct Layout {
  static constexpr int S = stages<DH>();
  static constexpr size_t TILE = static_cast<size_t>(BK) * DH * 2;  // a K or V tile
  static constexpr size_t Q = 0;                                   // [BQ * DH] bf16
  static constexpr size_t K = Q + static_cast<size_t>(BQ) * DH * 2;  // [S][BK * DH]
  static constexpr size_t V = K + S * TILE;                        // [S][BK * DH]
  static constexpr size_t BIAS = V + S * TILE;                     // [2 S][BK] f32
  static constexpr size_t BARS = BIAS + 2 * S * BK * 4;  // Q, K[S], V[S] full barriers
  static constexpr size_t COUNTS = BARS + (1 + 2 * S) * 8;  // [S] int: warpgroups done
  static constexpr size_t BYTES = 1024 + COUNTS + S * 4;
};

}  // namespace tc_pair

// bf16 at dh 192 and 256: one block of two warpgroups per (128-row query
// tile, head, item), warpgroup w on query rows [64 w, 64 w + 64). K and V
// tiles of 64 keys arrive by TMA in S-stage rings that both warpgroups read,
// each tile's key bias (-inf past T) beside K. Per tile j a warpgroup issues
// O += P_{j-1} V_{j-1} and S_j = Q K_j^T as one group of products, then the
// softmax and dropout hash of S_j (softmax_tile) while the other warpgroup's
// products run: the two take turns issuing (named barriers 1 and 2), so one
// warpgroup's elementwise work overlaps the other's tensor-core work. Once
// a warpgroup's group is done (named barrier 3 or 4 over its warps), the
// stages of K_j and V_{j-1} are free in it; the second of the two to get
// there refills them with K_{j+S} and V_{j-1+S} (one warp: the bias by its
// lanes, the boxes by lane 0).
template <int DH, bool DROP>
__global__ void __launch_bounds__(tc_pair::THREADS, 1)
attention_fwd_tc_pair(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                      bf16* __restrict__ o, float* __restrict__ lse, int T_len, Strides os,
                      float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using L = tc_pair::Layout<DH>;
  constexpr int S = L::S, BQ = tc_pair::BQ, BK = tc_pair::BK, THREADS = tc_pair::THREADS;
  constexpr int NCB = DH / 64;     // 64-wide column blocks
  constexpr int KSTEPS = DH / 16;  // k-steps of S = Q K^T
  constexpr int NB_S = BK / 8;     // n-blocks of S
  constexpr int NB_O = DH / 8;     // n-blocks of O
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(base + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(base + L::V);
  float* Bs = reinterpret_cast<float*>(base + L::BIAS);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  int* done = reinterpret_cast<int*>(base + L::COUNTS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;
  const int n_tiles = (min(max(kv_end[b], 1), T_len) + BK - 1) / BK;

  // key t's bias, -inf past T (such keys take no part at all)
  auto bias_at = [&](int t) { return t < T_len ? biasb[t] : -INFINITY; };
  // tile t's K boxes and key bias (lane i: keys i and i + 32, read before
  // as b0, b1) into its stages, by one whole warp; each lane arrives once
  // its bias is written, lane 0 with the boxes' bytes
  auto load_k = [&](int t, float b0, float b1) {
    uint64_t* bar = k_full + t % S;
    float* bt = Bs + (t % (2 * S)) * BK;
    bt[lane] = b0;
    bt[lane + 32] = b1;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, static_cast<uint32_t>(L::TILE));
      bf16* dst = Ks + (t % S) * BK * DH;
#pragma unroll
      for (int c = 0; c < NCB; ++c)
        tma_load_4d(dst + c * BK * 64, &kmap, bar, c * 64, t * BK, h, b);
    } else {
      mbar_arrive(bar);
    }
  };
  // tile t's V boxes (one thread)
  auto load_v = [&](int t) {
    uint64_t* bar = v_full + t % S;
    mbar_arrive_expect_tx(bar, static_cast<uint32_t>(L::TILE));
    bf16* dst = Vs + (t % S) * BK * DH;
#pragma unroll
    for (int c = 0; c < NCB; ++c) tma_load_4d(dst + c * BK * 64, &vmap, bar, c * 64, t * BK, h, b);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + s, 32);
      mbar_init(v_full + s, 1);
      done[s] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, static_cast<uint32_t>(BQ * DH * 2));
#pragma unroll
      for (int c = 0; c < NCB; ++c)
#pragma unroll
        for (int r = 0; r < BQ; r += 64)
          tma_load_4d(Qs + c * BQ * 64 + r * 64, &qmap, q_full, c * 64, q0 + r, h, b);
    }
    for (int t = 0; t < min(S, n_tiles); ++t) {
      load_k(t, bias_at(t * BK + lane), bias_at(t * BK + lane + 32));
      if (lane == 0) load_v(t);
    }
  }

  // this thread's two query rows and their dropout hash prefixes
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g;
  uint32_t rk[2] = {0u, 0u};
  if (DROP) {
    const uint32_t key = drop.key(b, h);
    rk[0] = (static_cast<uint32_t>(row0) << 16) ^ key;
    rk[1] = (static_cast<uint32_t>(row0 + 8) << 16) ^ key;
  }
  const bf16* Qw = Qs + wg * 64 * 64;  // this warpgroup's rows of each column block

  float acc[NB_O][4];
#pragma unroll
  for (int n = 0; n < NB_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums; the quad's sum at the end
  float s[NB_S][4];
  uint32_t pa[BK / 16][4];

  const int my_turn = 1 + wg, their_turn = 2 - wg;
  const bool refiller = (warp & 3) == 0;  // warp 0 of each warpgroup may refill
  auto issue_s = [&](int j) {
    const bf16* Kt = Ks + (j % S) * BK * DH;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = (kk & 3) * 16;  // within the 64-wide column block kk / 4
      wgmma_ss_n64(s, sw128_desc(Qw + (kk >> 2) * BQ * 64 + col, 16, 1024),
                   sw128_desc(Kt + (kk >> 2) * BK * 64 + col, 16, 1024));
    }
  };
  // after iteration j's products: K_j's and V_{j-1}'s stages are free in this
  // warpgroup; the second warpgroup here refills them (b0, b1: the bias of
  // tile j + S, read while the products ran)
  auto release = [&](int j, float b0, float b1) {
    named_sync(3 + wg, 128);
    if (refiller) {
      int second = 0;
      if (lane == 0) {
        __threadfence_block();
        second = atomicAdd(done + j % S, 1);
        if (second) done[j % S] = 0;
        __threadfence_block();
      }
      if (__shfl_sync(0xffffffffu, second, 0)) {
        if (j + S < n_tiles) load_k(j + S, b0, b1);
        if (lane == 0 && j >= 1 && j - 1 + S < n_tiles) load_v(j - 1 + S);
      }
    }
  };
  auto prefetch_bias = [&](int j, float& b0, float& b1) {
    if (refiller && j + S < n_tiles) {
      b0 = bias_at((j + S) * BK + lane);
      b1 = bias_at((j + S) * BK + lane + 32);
    }
  };

  if (tc_pair::TURNS && wg == 1) named_arrive(1, THREADS);  // warpgroup 0 issues first
  mbar_wait(q_full, 0);
  {  // tile 0: S alone
    float b0 = 0.f, b1 = 0.f;
    mbar_wait(k_full, 0);
#pragma unroll
    for (int n = 0; n < NB_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (tc_pair::TURNS) named_sync(my_turn, THREADS);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    if (tc_pair::TURNS && (wg == 0 || n_tiles > 1)) named_arrive(their_turn, THREADS);
    prefetch_bias(0, b0, b1);
    wgmma_wait<0>();
    release(0, b0, b1);
    softmax_tile<DH, DROP>(s, acc, m_run, l_run, pa, Bs, 0, T_len, sm_scale, rk, row0,
                           drop.thresh, t4);
  }
  for (int j = 1; j < n_tiles; ++j) {
    float b0 = 0.f, b1 = 0.f;
    mbar_wait(k_full + j % S, (j / S) & 1);
    mbar_wait(v_full + (j - 1) % S, ((j - 1) / S) & 1);
#pragma unroll
    for (int n = 0; n < NB_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (tc_pair::TURNS) named_sync(my_turn, THREADS);
    wgmma_fence();
    issue_pv<DH>(acc, pa, Vs + ((j - 1) % S) * BK * DH);
    issue_s(j);
    wgmma_commit();
    if (tc_pair::TURNS && (wg == 0 || j + 1 < n_tiles)) named_arrive(their_turn, THREADS);
    prefetch_bias(j, b0, b1);
    wgmma_wait<0>();
    release(j, b0, b1);
    softmax_tile<DH, DROP>(s, acc, m_run, l_run, pa, Bs + (j % (2 * S)) * BK, j * BK, T_len,
                           sm_scale, rk, row0, drop.thresh, t4);
  }
  mbar_wait(v_full + (n_tiles - 1) % S, ((n_tiles - 1) / S) & 1);
  wgmma_fence();
  issue_pv<DH>(acc, pa, Vs + ((n_tiles - 1) % S) * BK * DH);
  wgmma_commit();
  wgmma_wait<0>();

  store_rows<DH>(acc, m_run, l_run, o, lse, b, h, row0, 0, T_len, os, drop.keep_scale,
                 lse != nullptr, t4);
}

// -- bf16 above dh 256: each score once, the output columns split -------------

namespace tc_split {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile: two warpgroups' 32
constexpr int THREADS = 256;  // two warpgroups, one block an SM
constexpr int CW = fs2::attn::CHUNK;

// The stages of the V ring and of the K chunk ring, from what a block may
// opt into (227 KB) beside the Q tile, the P tile and the small arrays: two
// V tiles where that leaves at least 8 K chunks, else one; then as many K
// chunks as fit. Each chunk is 8 KB, and the loads in flight (KS - 1 chunks
// ahead) must cover the latency of a read from L2: dh 384 (2, 9), 512
// (1, 11), 640 (1, 7), 768 (1, 3).
constexpr size_t kSmemBudget = 232448 - 1024 - 2048;  // less alignment and the small arrays
template <int DH>
constexpr size_t fixed_bytes(int vs) {
  return static_cast<size_t>(BQ + vs * BK) * DH * 2 + BQ * BK * 2;
}
template <int DH>
constexpr int v_stages() {
  return fixed_bytes<DH>(2) + 8 * BK * CW * 2 <= kSmemBudget ? 2 : 1;
}
template <int DH>
constexpr int k_stages() {
  return static_cast<int>((kSmemBudget - fixed_bytes<DH>(v_stages<DH>())) / (BK * CW * 2));
}

template <int DH>
struct Layout {
  static constexpr int KS = k_stages<DH>(), VS = v_stages<DH>();
  // tile t's key bias goes to slot t % 4 with its first K chunk, KS - 1
  // steps ahead of that chunk: three tiles of NC chunks back must cover it
  static constexpr int BIAS_SLOTS = 4;
  static_assert((BIAS_SLOTS - 1) * (DH / CW) >= KS, "a bias slot is refilled while read");
  static constexpr size_t CHUNK_BYTES = static_cast<size_t>(BK) * CW * 2;
  static constexpr size_t V_BYTES = static_cast<size_t>(BK) * DH * 2;
  static constexpr size_t Q = 0;                                   // [BQ * DH] bf16
  static constexpr size_t K = Q + static_cast<size_t>(BQ) * DH * 2;  // [KS][BK * CW]
  static constexpr size_t V = K + KS * CHUNK_BYTES;                // [VS][BK * DH]
  static constexpr size_t P = V + VS * V_BYTES;                    // [BQ][BK] bf16
  static constexpr size_t BIAS = P + BQ * BK * 2;                  // [BIAS_SLOTS][BK] f32
  static constexpr size_t ROWS = BIAS + BIAS_SLOTS * BK * 4;  // [2][BQ] f32: row maxima, sums
  static constexpr size_t BARS = ROWS + 2 * BQ * 4;  // Q, K[KS], V[VS] full barriers
  static constexpr size_t BYTES = 1024 + BARS + (1 + KS + VS) * 8;
};

}  // namespace tc_split

// bf16 above dh 256 (attention_common.cuh group_width: up to 768): one
// block of two warpgroups per (64-row query tile, head, item), both on the
// same 64 query rows. Warpgroup w owns output columns [w dh/2, (w + 1) dh/2)
// and, of each key tile, keys [32 w, 32 w + 32): it computes S for those keys
// over the full dh (m64n32; Q stays in shared memory, K streams by TMA in
// 64-wide chunks through a KS-stage ring), the scaled, biased scores, their
// row maxima (exchanged through shared memory, so both take the same new
// maximum), the exponentials, its partial row sums and the dropout hash, and
// writes keep * P as bf16 into the tile's shared [query][key] tile; after a
// barrier, O += P V on its own columns (P and the V tile, by TMA in a
// VS-stage ring, both from shared memory). Each score and each product is
// issued once. The row sums of the two halves meet at the end; warpgroup 0
// writes the log-sum-exp.
template <int DH, bool DROP>
__global__ void __launch_bounds__(tc_split::THREADS, 1)
attention_fwd_tc_split(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                       bf16* __restrict__ o, float* __restrict__ lse, int T_len, Strides os,
                       float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using L = tc_split::Layout<DH>;
  constexpr int KS = L::KS, VS = L::VS, BQ = tc_split::BQ, BK = tc_split::BK;
  constexpr int CW = tc_split::CW;
  constexpr int NC = DH / CW;   // chunks of the contraction over dh
  constexpr int W = DH / 2;     // output columns a warpgroup
  constexpr int NB_S = 32 / 8;  // n-blocks of a warpgroup's 32 keys of S
  constexpr int NB_O = W / 8;   // n-blocks of its O
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base + L::Q);
  bf16* Kc = reinterpret_cast<bf16*>(base + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(base + L::V);
  bf16* Ps = reinterpret_cast<bf16*>(base + L::P);
  float* Bs = reinterpret_cast<float*>(base + L::BIAS);
  float* Rows = reinterpret_cast<float*>(base + L::ROWS);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + KS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;
  const int n_tiles = (min(max(kv_end[b], 1), T_len) + BK - 1) / BK;
  const int n_steps = n_tiles * NC;

  // step st: K chunk st % NC of key tile st / NC into stage st % KS, by
  // warp 0, every lane arriving (lane 0 with the box's bytes); with a
  // tile's first chunk, its key bias (-inf past T) into its slot
  auto load_step = [&](int st) {
    const int t = st / NC, c = st - t * NC;
    uint64_t* bar = k_full + st % KS;
    if (c == 0) {
      float* bt = Bs + (t % L::BIAS_SLOTS) * BK;
      const int k0 = t * BK;
      bt[lane] = k0 + lane < T_len ? biasb[k0 + lane] : -INFINITY;
      bt[lane + 32] = k0 + lane + 32 < T_len ? biasb[k0 + lane + 32] : -INFINITY;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, static_cast<uint32_t>(L::CHUNK_BYTES));
      tma_load_4d(Kc + (st % KS) * BK * CW, &kmap, bar, c * CW, t * BK, h, b);
    } else {
      mbar_arrive(bar);
    }
  };
  // key tile t's V boxes into stage t % VS (one thread)
  auto load_v = [&](int t) {
    uint64_t* bar = v_full + t % VS;
    mbar_arrive_expect_tx(bar, static_cast<uint32_t>(L::V_BYTES));
    bf16* dst = Vs + (t % VS) * BK * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load_4d(dst + c * BK * 64, &vmap, bar, c * 64, t * BK, h, b);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < KS; ++s) mbar_init(k_full + s, 32);
    for (int s = 0; s < VS; ++s) mbar_init(v_full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, static_cast<uint32_t>(BQ * DH * 2));
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_load_4d(Qs + c * BQ * 64, &qmap, q_full, c * 64, q0, h, b);
    }
    for (int st = 0; st < min(KS, n_steps); ++st) load_step(st);
    if (lane == 0)
      for (int t = 0; t < min(VS, n_tiles); ++t) load_v(t);
  }

  // this thread's two query rows (the same in both warpgroups), their
  // dropout hash prefixes, and their index within the tile
  const int rr = (warp & 3) * 16 + g;
  const int row0 = q0 + rr;
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
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums over its warpgroup's keys
  const bf16* Vw = Vs + (W / 64) * wg * BK * 64;  // this warpgroup's columns of a V tile

  mbar_wait(q_full, 0);
  for (int j = 0, st = 0; j < n_tiles; ++j) {
    float s[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // S = Q K^T for this warpgroup's 32 keys, chunk by chunk of dh
    for (int c = 0; c < NC; ++c, ++st) {
      mbar_wait(k_full + st % KS, (st / KS) & 1);
      const bf16* Kt = Kc + (st % KS) * BK * CW + wg * 32 * 64;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk)
        wgmma_ss_n32(s, sw128_desc(Qs + c * BQ * 64 + kk * 16, 16, 1024),
                     sw128_desc(Kt + kk * 16, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // step st - 1's products (at c = 0 also tile j - 1's P V) are done
      __syncthreads();  // ... in both warpgroups: its K stage, the P tile and the V stage
                        // of tile j - 1 are free
      if (warp == 0 && st >= 1) {
        if (st - 1 + KS < n_steps) load_step(st - 1 + KS);
        if (c == 0 && lane == 0 && j - 1 + VS < n_tiles) load_v(j - 1 + VS);
      }
    }
    wgmma_wait<0>();

    // scaled, biased scores and this warpgroup's row maxima over its keys
    const float* Bt = Bs + (j % L::BIAS_SLOTS) * BK + wg * 32;
    const int kw0 = j * BK + wg * 32;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[n][e], sm_scale, Bt[n * 8 + 2 * t4 + (e & 1)]);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t4 == 0) Rows[wg * BQ + rr + 8 * r] = mx[r];
    }
    __syncthreads();  // both halves' maxima are in Rows
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the tile holds a key inside [0, T), so the new max is finite; both
      // warpgroups take the same one
      const float m_new = fmaxf(m_run[r], fmaxf(mx[r], Rows[(wg ^ 1) * BQ + rr + 8 * r]));
      alpha[r] = fast_exp2((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // kept unnormalized exponentials, bf16, into the P tile; the hash's
    // part of this warpgroup's keys as in softmax_tile
    const uint32_t hk = DROP ? fs2::dropout_high(row0, kw0) : 0u;
    const uint32_t rkt[2] = {rk[0] ^ hk, rk[1] ^ hk};
    const uint32_t c_lo = static_cast<uint32_t>(kw0) & 0xffffu;
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fast_exp2((s[n][e] - m_run[r]) * kLog2e);
        l_run[r] += p;
        if (DROP) {
          const uint32_t col = c_lo + static_cast<uint32_t>(n * 8 + 2 * t4 + (e & 1));
          if (fs2::mix32(rkt[r] ^ col) < drop.thresh) p = 0.f;
        }
        s[n][e] = p;
      }
      const int chunk = wg * 4 + n;  // 8-key chunk of the tile's row
      *reinterpret_cast<uint32_t*>(Ps + sw128<BQ>(rr, chunk) + 2 * t4) =
          pack_bf16(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(Ps + sw128<BQ>(rr + 8, chunk) + 2 * t4) =
          pack_bf16(s[n][2], s[n][3]);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NB_O; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }
    fence_async_shared();
    __syncthreads();  // the P tile is whole

    // O += P V on this warpgroup's columns, both from shared memory
    mbar_wait(v_full + j % VS, (j / VS) & 1);
    const bf16* Vt = Vw + (j % VS) * BK * DH;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_cols<W, BK>(acc, sw128_desc(Ps + kk * 16, 16, 1024), Vt + kk * 16 * 64);
    wgmma_commit();
  }
  wgmma_wait<0>();

  // the row sums: each half's, then both (in one order, so both agree)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __syncthreads();  // the last tile's maxima are read
  if (t4 == 0) {
    Rows[wg * BQ + rr] = l_run[0];
    Rows[wg * BQ + rr + 8] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T_len) continue;
    const float l = Rows[rr + 8 * r] + Rows[BQ + rr + 8 * r];
    const float inv = drop.keep_scale / l;
    bf16* orow = o + b * os.b + h * os.h + t * os.t + wg * W + 2 * t4;
#pragma unroll
    for (int n = 0; n < NB_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (lse != nullptr && wg == 0 && t4 == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * T_len + t] = m_run[r] + logf(l);
  }
}

// A wide head dim (attention_common.cuh wide_dh): the same warpgroup and
// tiles, with blockIdx.x = query tile * groups + group. The block writes
// output columns [NG * group, NG * group + NG). Per key tile, S = Q K^T
// takes dh / 64 steps, each a 64-wide column chunk of the Q tile and of the
// K tile through a two-stage cp.async ring (4 k-steps of wgmma.m64n64k16);
// the V tile's NG group columns and the key bias arrive with the first
// chunk of their key tile, in their own two stages. Then the tile's
// softmax, dropout and P V are softmax_pv_tile's, as in the kernel above.
// Every group computes the same S, the same row statistics and the same
// mask (a function of (seed, stream, row, col) alone), so the groups agree
// on them bit for bit; group 0 writes the log-sum-exp.
template <int NG, bool DROP>
__global__ void __launch_bounds__(tc_fwd::THREADS, 2)
attention_fwd_tc_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ key_bias,
                      const int* __restrict__ kv_end, bf16* __restrict__ o,
                      float* __restrict__ lse, int T_len, int dh, Strides qs, Strides ks,
                      Strides vs, Strides os, float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using namespace tc_fwd;
  constexpr int CW = fs2::attn::CHUNK;
  constexpr int NB_S = BK / 8;  // n-blocks of S
  constexpr int NB_O = NG / 8;  // n-blocks of this group's O
  extern __shared__ unsigned char smem_raw[];
  bf16* Qc = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* Kc = Qc + 2 * BQ * CW;  // [2][BK * CW]
  bf16* Vs = Kc + 2 * BK * CW;  // [2][BK * NG]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * NG);  // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int n_groups = dh / NG;
  const int grp = blockIdx.x % n_groups;
  const int g0 = grp * NG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (blockIdx.x / n_groups) * BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h + g0;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;
  const int n_tiles = (min(max(kv_end[b], 1), T_len) + BK - 1) / BK;
  const int n_chunks = dh / CW;
  const int n_steps = n_tiles * n_chunks;

  // step st: chunk st % n_chunks of key tile st / n_chunks into stage st & 1;
  // with a tile's first chunk, its V group columns and bias into stage j & 1
  auto load_step = [&](int st) {
    const int j = st / n_chunks, c = st - j * n_chunks, k0 = j * BK;
    load_tile<BQ, CW, THREADS>(Qc + (st & 1) * BQ * CW, qb + c * CW, qs.t, q0, T_len, tid);
    load_tile<BK, CW, THREADS>(Kc + (st & 1) * BK * CW, kb + c * CW, ks.t, k0, T_len, tid);
    if (c == 0) {
      load_tile<BK, NG, THREADS>(Vs + (j & 1) * BK * NG, vb, vs.t, k0, T_len, tid);
      if (tid < BK) {
        const bool ok = k0 + tid < T_len;
        cp_async4(Bs + (j & 1) * BK + tid, biasb + (ok ? k0 + tid : 0), ok);
      }
    }
  };

  load_step(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + (lane >> 2);
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
  float l_run[2] = {0.f, 0.f};
  float s[NB_S][4];

  for (int j = 0, st = 0; j < n_tiles; ++j) {
#pragma unroll
    for (int n = 0; n < NB_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int c = 0; c < n_chunks; ++c, ++st) {
      if (st + 1 < n_steps) load_step(st + 1);
      cp_async_commit();
      cp_async_wait<1>();  // step st's chunks (and its tile's V and bias) landed
      fence_async_shared();
      __syncthreads();
      const bf16* Qt = Qc + (st & 1) * BQ * CW;
      const bf16* Kt = Kc + (st & 1) * BK * CW;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk)
        wgmma_ss_n64(s, sw128_desc(Qt + kk * 16, 16, 1024), sw128_desc(Kt + kk * 16, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();  // stage st & 1 is consumed before step st + 2 refills it
    }
    softmax_pv_tile<NG, DROP>(s, acc, m_run, l_run, Bs + (j & 1) * BK, Vs + (j & 1) * BK * NG,
                              j * BK, T_len, sm_scale, rk, row0, drop.thresh, t4);
    // the V and bias stage j & 1 is refilled by the load of step (j + 2) * chunks,
    // issued after the next tile's first barrier
  }

  store_rows<NG>(acc, m_run, l_run, o, lse, b, h, row0, g0, T_len, os, drop.keep_scale,
                 lse != nullptr && grp == 0, t4);
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

// a wide head dim: 64-wide chunks of the Q and K tiles padded to 65
// columns, the V tile's NG group columns, the probability tile, key bias
template <int NG>
constexpr size_t wide_smem_floats() {
  constexpr int CW = fs2::attn::CHUNK;
  return (BQ + BK) * (CW + 1) + BK * NG + BQ * (BK + 1) + BK;
}

}  // namespace f32_fwd

// One key tile of the f32 forward once this thread's raw scores are in `s`
// (query row `row`, keys part + 4 j): scale and bias them, take the online
// softmax and the dropout hash, and add P V into `acc` for this thread's NO
// columns part + 4 m of the V tile `Vs` (BK rows of LDV floats). Holds a
// barrier.
template <int NO, int LDV>
__device__ __forceinline__ void f32_softmax_pv(float (&s)[f32_fwd::BK / 4], float (&acc)[NO],
                                               float& m_run, float& l_run, const float* Bs,
                                               float* Ps, const float* Vs, int row, int part,
                                               int q0, int k0, float sm_scale, uint32_t key,
                                               const Dropout& drop) {
  constexpr int BK = f32_fwd::BK;
  constexpr int LP = BK + 1;
  constexpr int NS = BK / 4;
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
    const float* vrow = Vs + j * LDV + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) acc[m] = fmaf(p, vrow[4 * m], acc[m]);
  }
}

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

    f32_softmax_pv<NO, DH>(s, acc, m_run, l_run, Bs, Ps, Vs, row, part, q0, k0, sm_scale,
                           key, drop);
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

// A wide head dim in f32: blockIdx.x = query tile * groups + group, the
// block's output columns [NG * group, NG * group + NG). Per key tile the
// scores are summed over dh in 64-wide chunks of the Q and K tiles staged
// one after the other (the same order over d as the kernel above); the V
// tile's group columns and the key bias are staged with the first chunk.
// Group 0 writes the log-sum-exp.
template <int NG>
__global__ void __launch_bounds__(f32_fwd::THREADS)
attention_fwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ key_bias,
                       const int* __restrict__ kv_end, float* __restrict__ o,
                       float* __restrict__ lse, int T_len, int dh, Strides qs, Strides ks,
                       Strides vs, Strides os, float sm_scale, Dropout drop) {
  using namespace f32_fwd;
  extern __shared__ float smem[];
  constexpr int CW = fs2::attn::CHUNK;
  constexpr int LD = CW + 1;
  constexpr int LP = BK + 1;
  constexpr int NO = NG / 4;  // output columns per thread
  constexpr int NS = BK / 4;  // score columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * NG;
  float* Bs = Ps + BQ * LP;

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int part = tid & 3;
  const int n_groups = dh / NG;
  const int grp = blockIdx.x % n_groups;
  const int g0 = grp * NG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = (blockIdx.x / n_groups) * BQ;
  const uint32_t key = drop.thresh ? drop.key(b, h) : 0u;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h + g0;
  const float* biasb = key_bias + static_cast<long long>(b) * T_len;
  const int k_end = min(max(kv_end[b], 1), T_len);

  float acc[NO];
#pragma unroll
  for (int m = 0; m < NO; ++m) acc[m] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += CW) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int i = tid; i < BQ * CW; i += THREADS) {
        const int r = i / CW, d = i % CW, t = q0 + r;
        Qs[r * LD + d] = t < T_len ? qb[t * qs.t + c0 + d] : 0.f;
      }
      for (int i = tid; i < BK * CW; i += THREADS) {
        const int r = i / CW, d = i % CW, t = k0 + r;
        Ks[r * LD + d] = t < T_len ? kb[t * ks.t + c0 + d] : 0.f;
      }
      if (c0 == 0) {
        for (int i = tid; i < BK * NG; i += THREADS) {
          const int r = i / NG, d = i % NG, t = k0 + r;
          Vs[r * NG + d] = t < T_len ? vb[t * vs.t + d] : 0.f;
        }
        if (tid < BK) {
          const int t = k0 + tid;
          // keys past the end take no part at all (-inf), unlike masked keys
          Bs[tid] = t < T_len ? biasb[t] : -INFINITY;
        }
      }
      __syncthreads();
      const float* qrow = Qs + row * LD;
#pragma unroll 4
      for (int d = 0; d < CW; ++d) {
        const float qv = qrow[d];
#pragma unroll
        for (int j = 0; j < NS; ++j) s[j] = fmaf(qv, Ks[(part + 4 * j) * LD + d], s[j]);
      }
    }

    f32_softmax_pv<NO, NG>(s, acc, m_run, l_run, Bs, Ps, Vs, row, part, q0, k0, sm_scale,
                           key, drop);
  }

  const int t = q0 + row;
  if (t < T_len) {
    const float inv = (1.f / l_run) * drop.keep_scale;
    float* orow = o + b * os.b + h * os.h + t * os.t + g0 + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) orow[4 * m] = acc[m] * inv;
    if (lse != nullptr && grp == 0 && part == 0)
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
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_fwd_f32<DH>, static_cast<int>(smem));
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
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_fwd_tc<DH, DROP>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  attention_fwd_tc<DH, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, kv_end, static_cast<bf16*>(o), lse, T_len, qs, ks, vs, os, sm_scale, drop);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null where the driver lacks it
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static std::atomic<EncodeTiledFn> fn{nullptr};
  EncodeTiledFn f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || p == nullptr) return nullptr;
  f = reinterpret_cast<EncodeTiledFn>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// A [B, H, T, dh] bf16 tensor with element strides `st` over (B, H, T) and
// dh contiguous, as the 4-D TMA map (dh, T, H, B) whose boxes are 64
// columns by 64 rows in the 128-byte swizzle (tensor_core.cuh); rows past T
// read as zeros. The strides are multiples of 16 bytes (the wrapper checks
// 16-byte rows); a dimension of extent 1 is never stepped over, so it gets
// a stride the encoder accepts whatever the tensor's.
cudaError_t tile_map(CUtensorMap* map, const void* base, int B, int H, int T_len, int dh,
                     Strides st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const long long s_t = T_len == 1 ? dh : st.t;
  const long long s_h = H == 1 ? s_t * T_len : st.h;
  const long long s_b = B == 1 ? s_h * H : st.b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_t) * 2,
                                 static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the bf16 kernels that read q, k and v through TMA maps: attention_fwd_tc_pair
// (one block per 128-row query tile) and attention_fwd_tc_split (64)
template <typename Kernel>
cudaError_t launch_tma(Kernel kernel, fs2::SmemOptIn& opt_in, size_t smem, int block_rows,
                       const void* q, const void* k, const void* v, const float* bias,
                       const int* kv_end, void* o, float* lse, int B, int H, int T_len, int dh,
                       Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
                       Dropout drop, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = tile_map(&qm, q, B, H, T_len, dh, qs);
  if (err == cudaSuccess) err = tile_map(&km, k, B, H, T_len, dh, ks);
  if (err == cudaSuccess) err = tile_map(&vm, v, B, H, T_len, dh, vs);
  if (err == cudaSuccess) err = fs2::smem_opt_in(opt_in, kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + block_rows - 1) / block_rows, H, B);
  kernel<<<grid, 256, smem, stream>>>(qm, km, vm, bias, kv_end, static_cast<bf16*>(o), lse,
                                      T_len, os, sm_scale, drop);
  return cudaGetLastError();
}

template <int DH, bool DROP>
cudaError_t launch_tc_pair(const void* q, const void* k, const void* v, const float* bias,
                           const int* kv_end, void* o, float* lse, int B, int H, int T_len,
                           Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
                           Dropout drop, cudaStream_t stream) {
  static fs2::SmemOptIn opt_in;
  return launch_tma(attention_fwd_tc_pair<DH, DROP>, opt_in, tc_pair::Layout<DH>::BYTES,
                    tc_pair::BQ, q, k, v, bias, kv_end, o, lse, B, H, T_len, DH, qs, ks, vs, os,
                    sm_scale, drop, stream);
}

template <int DH, bool DROP>
cudaError_t launch_tc_split(const void* q, const void* k, const void* v, const float* bias,
                            const int* kv_end, void* o, float* lse, int B, int H, int T_len,
                            Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
                            Dropout drop, cudaStream_t stream) {
  static fs2::SmemOptIn opt_in;
  return launch_tma(attention_fwd_tc_split<DH, DROP>, opt_in, tc_split::Layout<DH>::BYTES,
                    tc_split::BQ, q, k, v, bias, kv_end, o, lse, B, H, T_len, DH, qs, ks, vs, os,
                    sm_scale, drop, stream);
}

// a wide head dim: one block per (query tile, column group), head, item
template <int NG>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v, const float* bias,
                            const int* kv_end, void* o, float* lse, int B, int H, int T_len,
                            int dh, Strides qs, Strides ks, Strides vs, Strides os,
                            float sm_scale, Dropout drop, cudaStream_t stream) {
  using namespace f32_fwd;
  const size_t smem = wide_smem_floats<NG>() * sizeof(float);
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_fwd_f32_wide<NG>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + BQ - 1) / BQ * (dh / NG), H, B);
  attention_fwd_f32_wide<NG><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, kv_end, static_cast<float*>(o), lse, T_len, dh, qs, ks, vs, os, sm_scale, drop);
  return cudaGetLastError();
}

template <int NG, bool DROP>
cudaError_t launch_tc_wide(const void* q, const void* k, const void* v, const float* bias,
                           const int* kv_end, void* o, float* lse, int B, int H, int T_len,
                           int dh, Strides qs, Strides ks, Strides vs, Strides os,
                           float sm_scale, Dropout drop, cudaStream_t stream) {
  using namespace tc_fwd;
  const size_t smem = wide_smem_bytes<NG>();
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_fwd_tc_wide<NG, DROP>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + BQ - 1) / BQ * (dh / NG), H, B);
  attention_fwd_tc_wide<NG, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, kv_end, static_cast<bf16*>(o), lse, T_len, dh, qs, ks, vs, os, sm_scale, drop);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// The column groups the kernel of `dtype` runs head dim dh in, each
// computing S = Q K^T over the full dh for its output columns: 1 at a
// built dh and for bf16 up to dh 768 (attention_fwd_tc_split), dh /
// group_width above; 0 for a dtype or dh the C entry refuses.
extern "C" int attention_fwd_column_groups(int dtype, int dh) {
  if (dtype != fs2::kFloat32 && dtype != fs2::kBFloat16) return 0;
  if (fs2::attn::built_dh(dh)) return 1;
  if (!fs2::attn::wide_dh(dh)) return 0;
  return dh / fs2::attn::group_width(dtype == fs2::kBFloat16, dh);
}

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
  if (B <= 0 || H <= 0 || T_len <= 0 || thresh < 0 || thresh > 0xffffffffLL ||
      (thresh > 0 && seed == nullptr) ||
      kv_end == nullptr || row_offset < 0 || head_offset < 0 || head_offset + H > heads_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale,
                     row_offset, head_offset, heads_total};
  const float* bias = static_cast<const float*>(key_bias);
  int* kend = static_cast<int*>(kv_end);
  float* l = static_cast<float*>(lse);
  const bool dropout = thresh > 0;
  if ((dtype != fs2::kFloat32 && dtype != fs2::kBFloat16) ||
      !(fs2::attn::built_dh(dh) || fs2::attn::wide_dh(dh)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = fs2::attn::launch_kv_end(bias, B, T_len, kend, st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define FS2_FWD_ARGS q, k, v, bias, kend, o, l, B, H, T_len, qs, ks, vs, os, sm_scale, drop, st
#define FS2_TC(LAUNCH, DH) \
  return dropout ? LAUNCH<DH, true>(FS2_FWD_ARGS) : LAUNCH<DH, false>(FS2_FWD_ARGS)
  if (fs2::attn::wide_dh(dh)) {
#define FS2_WIDE_ARGS q, k, v, bias, kend, o, l, B, H, T_len, dh, qs, ks, vs, os, sm_scale, drop, st
    if (dtype == fs2::kFloat32) return launch_f32_wide<128>(FS2_WIDE_ARGS);
    switch (fs2::attn::group_width(true, dh)) {
      case 256: return dropout ? launch_tc_wide<256, true>(FS2_WIDE_ARGS)
                               : launch_tc_wide<256, false>(FS2_WIDE_ARGS);
      case 128: return dropout ? launch_tc_wide<128, true>(FS2_WIDE_ARGS)
                               : launch_tc_wide<128, false>(FS2_WIDE_ARGS);
      default: break;  // one group: the whole dh
    }
#undef FS2_WIDE_ARGS
    switch (dh) {
      case 384: FS2_TC(launch_tc_split, 384);
      case 512: FS2_TC(launch_tc_split, 512);
      case 640: FS2_TC(launch_tc_split, 640);
      case 768: FS2_TC(launch_tc_split, 768);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == fs2::kFloat32) {
    switch (dh) {
      case 64: return launch_f32<64>(FS2_FWD_ARGS);
      case 128: return launch_f32<128>(FS2_FWD_ARGS);
      case 192: return launch_f32<192>(FS2_FWD_ARGS);
      default: return launch_f32<256>(FS2_FWD_ARGS);
    }
  }
  switch (dh) {
    case 64: FS2_TC(launch_tc, 64);
    case 128: FS2_TC(launch_tc, 128);
    case 192: FS2_TC(launch_tc_pair, 192);
    default: FS2_TC(launch_tc_pair, 256);
  }
#undef FS2_TC
#undef FS2_FWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
