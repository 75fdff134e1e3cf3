// Attention backward with dropout on the attention probabilities (the FA2
// backward), the gradient of attention_fwd.cu:
//
//   O = dropout_p(softmax(sm_scale * Q K^T + key_bias)) V
//   P     = exp(sm_scale * Q K^T + key_bias - lse)      (lse from the forward)
//   dP    = dO V^T
//   dprob = keep * dP / (1 - p)
//   dS    = P * (dprob - D),  D = rowsum(dO * O)
//   dV = (keep * P / (1 - p))^T dO,  dK = sm_scale * dS^T Q,  dQ = sm_scale * dS K
//
// q, k, v, o, do: [B, H, T, dh] (any strides over B, H, T; dh contiguous);
// key_bias [B, T] f32; lse [B, H, T] f32; dk, dv [B, H, T, dh] contiguous in
// q's dtype. Scratch that the C entry's pre-pass kernels fill before the
// kernel runs: kv_end [B] int32 (as in attention_fwd.cu), D [B, H, T] f32,
// and dq_acc [B, H, T, dh] f32 contiguous, zeroed there and summed into with
// atomicAdd. The key bias gets no gradient. The keep mask is regenerated
// from (seed, stream, row, col) exactly as the forward drew it, at the same
// (row_offset, head_offset, heads_total) (common.cuh dropout_stream).
//
// A block whose keys all lie at or past kv_end[b] writes dK = dV = 0 and
// adds nothing to dQ: exact, since P is 0 in f32 for every key past the
// item's last valid one. A query row of an item with no valid key (lse
// below -5e8, where m + log(l) has lost log(l) to the -1e9 bias) had every
// exponential equal to 1 in the forward, so its P is exp(s - lse) / T; the
// kernels divide by T there, which gives the plain version's uniform 1/T.
//
// Replaces three TPU kernels of the JAX package:
// fastspeech2_lightning_tpu/ops/attention_dropout.py:190 _attention_bwd
// (_bwd_kernel :80), and the streaming backward _stream_bwd :494 (dQ,
// _sbwd_dq_kernel :332, call :506; dK dV, _sbwd_dkv_kernel :375, call :543).
//
// Bound: 10*H*T*dh operations (five T x T x dh products) per key the mask
// keeps and query row, against about 8*B*H*T*dh elements moved; at the
// decoder's training shape (B=16, H=2, T=2048, dh=128, bf16) 172 GFLOP with
// every key, about 174 us at the 989 TFLOP/s bf16 tensor-core peak:
// compute-bound.
//
// Two kernels; the dtype picks one (not a fallback):
//
// bf16 (attention_bwd_tc): FA2's backward on Hopper warpgroup products, one
// launch after two small pre-passes (kv_end, and D = rowsum(dO * O) with the
// f32 dQ buffer zeroed). One block of two warpgroups per (128-key tile,
// head, batch), each warpgroup 64 keys (each warp 16), with dK and dV
// accumulated in registers (f32). K and V stay in shared memory; the block
// loops over 64-row query tiles whose Q, dO, lse and D stream through a
// two-stage cp.async ring. All tiles use the 128-byte-swizzled layout of
// tensor_core.cuh. Per query tile a warpgroup computes S^T = K Q^T and
// dP^T = V dO^T with wgmma.m64n64k16 (all operands from shared memory),
// forms P^T, the keep mask and dS^T on the f32 accumulators in registers,
// rounds keep * P / (1 - p) and dS to bf16 (as the JAX kernel does,
// attention_dropout.py:102, :122) and feeds them from registers as the A
// operand of dV += (keep P)^T dO and dK += dS^T Q (wgmma.m64n{dh}k16, dO and
// Q read transposed). dS^T also goes to shared memory, and each warpgroup
// computes 64 columns of the tile's dQ = dS K with both operands read
// transposed, adding it into the f32 buffer with atomicAdd (a float2 per
// column pair), so dQ's summation order varies from run to run.
// What limits it: within a warpgroup the products and the elementwise work
// (exponential, hash, dS) run one after the other, with one block per SM
// (two warpgroups) to overlap them; then the T/128 atomic adds per dQ
// element. One block per SM also makes the grid (ceil(T/128) * H * B
// blocks) run in whole waves: at the training buckets up to T = 1216 the
// blocks that skip past kv_end do not remove a wave, so the skip saves time
// only where it does (T = 2016). FA3's structure (a producer warp with TMA,
// dQ through shared memory and a bulk reduce) is the next step.
//
// f32 (attention_bwd_f32): the CUDA-core kernel of the f32 card-vs-CPU
// checks (rel-L2 1e-5): one block of 256 threads per (64-key tile, head,
// batch), four threads per key row, Q, dO, lse and D staged per 64-row query
// tile, f32 FMA throughout, dQ by atomicAdd, the same kv_end skip.

#include <math.h>

#include "attention_common.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using fs2::attn::Dropout;
using fs2::attn::kLog2e;
using fs2::attn::Strides;
using fs2::tc::bf16;

constexpr float kNoKeyLse = -5e8f;  // lse below this: the item has no valid key

// dK = dV = 0 for a block's rows [k0, k0 + rows) below T (16-byte stores)
template <int DH, int THREADS, typename T>
__device__ __forceinline__ void zero_rows(T* dk, T* dv, long long row_base, int k0, int rows,
                                          int T_len, int tid) {
  constexpr int CH = DH * sizeof(T) / 16;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int t = k0 + i / CH;
    if (t >= T_len) continue;
    const long long off = (row_base + t) * DH * static_cast<long long>(sizeof(T)) / 16 + i % CH;
    reinterpret_cast<uint4*>(dk)[off] = z;
    reinterpret_cast<uint4*>(dv)[off] = z;
  }
}

// Pre-pass: D = rowsum(dO * O) per (b, h, t) row, and that row of dq_acc
// zeroed; one warp per row.
template <typename T, int DH>
__global__ void __launch_bounds__(256)
bwd_prepass(const T* __restrict__ dout, const T* __restrict__ o, int H, int T_len,
            Strides ds, Strides os, float* __restrict__ dsum, float* __restrict__ dq_acc,
            long long rows) {
  const long long r = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int t = static_cast<int>(r % T_len);
  const long long bh = r / T_len;
  const long long h = bh % H, b = bh / H;
  const T* drow = dout + b * ds.b + h * ds.h + t * ds.t;
  const T* orow = o + b * os.b + h * os.h + t * os.t;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) {
    const int d = lane + 32 * i;
    acc = fmaf(fs2::to_f32(drow[d]), fs2::to_f32(orow[d]), acc);
    dq_acc[r * DH + d] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[r] = acc;
}

// -- bf16: tensor cores -------------------------------------------------------

namespace tc_bwd {

constexpr int BK = 128;       // keys per block: two warpgroups of 64
constexpr int BQ = 64;        // query rows per tile
constexpr int THREADS = 256;  // 8 warps x 16 key rows

template <int DH>
constexpr size_t smem_bytes() {
  // 1024 bytes to align the tiles to the swizzle period; K and V tiles, two
  // stages of Q and dO tiles, the dS^T tile (bf16); two stages of lse and D
  return 1024 + (2 * BK * DH + 4 * BQ * DH + BK * BQ) * sizeof(bf16) +
         4 * BQ * sizeof(float);
}

}  // namespace tc_bwd

template <int DH, bool DROP>
__global__ void __launch_bounds__(tc_bwd::THREADS, 1)
attention_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int T_len, Strides qs, Strides ks, Strides vs, Strides ds, float sm_scale,
                 Dropout drop) {
  using namespace fs2::tc;
  using namespace tc_bwd;
  constexpr int KSTEPS = DH / 16;  // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int NB_S = BQ / 8;     // n-blocks of S^T (query columns)
  constexpr int NB_O = DH / 8;     // n-blocks of dK, dV
  constexpr int NB_Q = 8;          // n-blocks of a warpgroup's 64 columns of dQ
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* Vs = Ks + BK * DH;
  bf16* Qs = Vs + BK * DH;      // [2][BQ * DH]
  bf16* Os = Qs + 2 * BQ * DH;  // [2][BQ * DH], the dO tiles
  bf16* Ss = Os + 2 * BQ * DH;  // [BK][BQ], dS^T
  float* Ls = reinterpret_cast<float*>(Ss + BK * BQ);  // [2][BQ]
  float* Dd = Ls + 2 * BQ;                             // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // warpgroup: keys 64 * wg .. of the block
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const long long row_base = bh * T_len;

  if (k0 >= min(max(kv_end[b], 1), T_len)) {
    zero_rows<DH, THREADS>(dk, dv, row_base, k0, BK, T_len, tid);
    return;
  }

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + row_base;
  const float* dsum_b = dsum + row_base;
  float* dq_b = dq_acc + row_base * DH;

  auto load_q = [&](int stage, int q0) {
    load_tile<BQ, DH, THREADS>(Qs + stage * BQ * DH, qb, qs.t, q0, T_len, tid);
    load_tile<BQ, DH, THREADS>(Os + stage * BQ * DH, db, ds.t, q0, T_len, tid);
    const int i = tid & (BQ - 1);
    const bool ok = q0 + i < T_len;
    if (tid < BQ)
      cp_async4(Ls + stage * BQ + i, lse_b + (ok ? q0 + i : 0), ok);
    else if (tid < 2 * BQ)
      cp_async4(Dd + stage * BQ + i, dsum_b + (ok ? q0 + i : 0), ok);
  };

  load_tile<BK, DH, THREADS>(Ks, kb, ks.t, k0, T_len, tid);
  load_tile<BK, DH, THREADS>(Vs, vb, vs.t, k0, T_len, tid);
  load_q(0, 0);
  cp_async_commit();

  // this thread's two key rows: bias, validity, dropout hash prefix
  int kr[2];
  float kbias[2];
  uint32_t kx[2];
  const uint32_t key = DROP ? drop.key(b, h) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = k0 + warp * 16 + g + 8 * r;
    kbias[r] = kr[r] < T_len ? key_bias[static_cast<long long>(b) * T_len + kr[r]] : 0.f;
    kx[r] = static_cast<uint32_t>(kr[r]) ^ key;
  }
  const float log2_T = log2f(static_cast<float>(T_len));

  float dka[NB_O][4], dva[NB_O][4];
#pragma unroll
  for (int n = 0; n < NB_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_qt = (T_len + BQ - 1) / BQ;
  for (int i = 0; i < n_qt; ++i) {
    if (i + 1 < n_qt) load_q((i + 1) & 1, (i + 1) * BQ);
    cp_async_commit();
    cp_async_wait<1>();  // query tile i (and K, V) landed
    fence_async_shared();
    __syncthreads();     // ... and the previous tile's dQ reads of Ss are done
    const bf16* Qt = Qs + (i & 1) * BQ * DH;
    const bf16* Ot = Os + (i & 1) * BQ * DH;
    const float* Lt = Ls + (i & 1) * BQ;
    const float* Dt = Dd + (i & 1) * BQ;
    const int q0 = i * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries,
    // all operands from shared memory
    float sp[NB_S][4], dpt[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = dpt[n][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = (kk & 3) * 16;  // within the 64-wide column block kk / 4
      const int kv_off = (kk >> 2) * BK * 64 + wg * 64 * 64 + col;
      const int q_off = (kk >> 2) * BQ * 64 + col;
      wgmma_ss_n64(sp, sw128_desc(Ks + kv_off, 16, 1024), sw128_desc(Qt + q_off, 16, 1024));
      wgmma_ss_n64(dpt, sw128_desc(Vs + kv_off, 16, 1024), sw128_desc(Ot + q_off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();

    // P^T (f32) and keep * P / (1 - p) as the A fragments of dV's product;
    // then dS^T = P^T * (keep * dP^T / (1 - p) - D) in place of dP^T
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = n * 8 + 2 * t4 + (e & 1);
        const int qrow = q0 + c;
        float p = 0.f;
        if (kr[r] < T_len && qrow < T_len) {
          const float lq = Lt[c];
          const float x = fmaf(sp[n][e], sm_scale, kbias[r]);
          p = fast_exp2((x - lq) * kLog2e - (lq < kNoKeyLse ? log2_T : 0.f));
        }
        const bool keep =
            !DROP || fs2::mix32((static_cast<uint32_t>(qrow) << 16) ^ kx[r]) >= drop.thresh;
        sp[n][e] = keep ? p * drop.keep_scale : 0.f;
        dpt[n][e] = p * ((keep ? dpt[n][e] * drop.keep_scale : 0.f) - Dt[c]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      c_to_a(pa[kk], sp[2 * kk], sp[2 * kk + 1]);
      c_to_a(sa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    }

    // dV += (keep P / (1 - p))^T dO and dK += dS^T Q, A from registers, B
    // (dO, Q) from shared memory read transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t od = sw128_desc(Ot + kk * 16 * 64, BQ * 128, 1024);
      const uint64_t qd = sw128_desc(Qt + kk * 16 * 64, BQ * 128, 1024);
      if constexpr (DH == 128) {
        wgmma_rs_n128(dva, pa[kk], od);
        wgmma_rs_n128(dka, sa[kk], qd);
      } else {
        wgmma_rs_n64(dva, pa[kk], od);
        wgmma_rs_n64(dka, sa[kk], qd);
      }
    }
    wgmma_commit();

    // dS^T (bf16) to shared memory, [key][query] in the 128-byte-swizzled
    // layout, while the products run
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
      const int row = warp * 16 + g;
      *reinterpret_cast<uint32_t*>(Ss + sw128<BK>(row, n) + 2 * t4) = sa[n >> 1][(n & 1) * 2];
      *reinterpret_cast<uint32_t*>(Ss + sw128<BK>(row + 8, n) + 2 * t4) =
          sa[n >> 1][(n & 1) * 2 + 1];
    }
    fence_async_shared();
    wgmma_wait<0>();
    __syncthreads();

    // dQ = dS K, A = dS and B = K both read transposed from shared memory;
    // this warp's rows are queries 16 (warp % 4) ... At dh 128 warpgroup wg
    // takes dQ's columns [64 wg, 64 wg + 64) over all 128 keys; at dh 64 it
    // takes all columns over keys [64 wg, 64 wg + 64), and the atomics sum
    // the two halves. (No branch on wg around the products: nvcc 12.9
    // crashes on one.)
    {
      constexpr int DQ_STEPS = DH == 128 ? BK / 16 : BK / 32;
      const int key0 = DH == 128 ? 0 : 64 * wg;
      const int cblk = DH == 128 ? wg : 0;
      float dqa[NB_Q][4];
#pragma unroll
      for (int n = 0; n < NB_Q; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_STEPS; ++kk) {
        const int row = key0 + kk * 16;
        wgmma_ss_n64<1, 1>(dqa, sw128_desc(Ss + row * 64, BK * 128, 1024),
                           sw128_desc(Ks + cblk * BK * 64 + row * 64, BK * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qrow = q0 + (warp & 3) * 16 + g + 8 * r;
        if (qrow >= T_len) continue;
        float* dst = dq_b + static_cast<long long>(qrow) * DH + cblk * 64 + 2 * t4;
#pragma unroll
        for (int n = 0; n < NB_Q; ++n)  // one vector add per column pair (sm_90)
          atomicAdd(reinterpret_cast<float2*>(dst + n * 8),
                    make_float2(dqa[n][2 * r] * sm_scale, dqa[n][2 * r + 1] * sm_scale));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= T_len) continue;
    const long long off = (row_base + kr[r]) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < NB_O; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// -- f32: CUDA cores ----------------------------------------------------------

namespace f32_bwd {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per block
constexpr int THREADS = 256;  // 4 threads per key (or query) row

template <int DH>
constexpr size_t smem_floats() {
  // K, V, Q, dO tiles padded to DH + 1; P-kept and dS tiles [key][query]
  // padded to BQ + 1; key bias, lse, D.
  return 4 * 64 * (DH + 1) + 2 * BK * (BQ + 1) + BK + 2 * BQ;
}

}  // namespace f32_bwd

template <int DH>
__global__ void __launch_bounds__(f32_bwd::THREADS)
attention_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                  const float* __restrict__ lse, const float* __restrict__ dsum,
                  float* __restrict__ dq_acc, float* __restrict__ dk, float* __restrict__ dv,
                  int T_len, Strides qs, Strides ks, Strides vs, Strides ds, float sm_scale,
                  Dropout drop) {
  using namespace f32_bwd;
  extern __shared__ float smem[];
  constexpr int LD = DH + 1;
  constexpr int LP = BQ + 1;
  constexpr int NO = DH / 4;  // accumulator columns per thread
  constexpr int NS = BQ / 4;  // score columns per thread
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Ds = Qs + BQ * LD;  // dO tile
  float* PK = Ds + BQ * LD;  // [key][query] keep * P / (1 - p)
  float* SS = PK + BK * LP;  // [key][query] dS
  float* Bs = SS + BK * LP;
  float* Ls = Bs + BK;
  float* Dd = Ls + BQ;

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // key row for dK/dV, query row for dQ
  const int part = tid & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int k0 = blockIdx.x * BK;
  const long long bh = static_cast<long long>(b) * H + h;

  if (k0 >= min(max(kv_end[b], 1), T_len)) {
    zero_rows<DH, THREADS>(dk, dv, bh * T_len, k0, BK, T_len, tid);
    return;
  }

  const uint32_t key = drop.thresh ? drop.key(b, h) : 0u;
  const float log_T = logf(static_cast<float>(T_len));

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + bh * T_len;
  const float* dsum_b = dsum + bh * T_len;
  float* dq_b = dq_acc + bh * T_len * DH;

  for (int i = tid; i < BK * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, t = k0 + r;
    const bool ok = t < T_len;
    Ks[r * LD + d] = ok ? kb[t * ks.t + d] : 0.f;
    Vs[r * LD + d] = ok ? vb[t * vs.t + d] : 0.f;
  }
  if (tid < BK) {
    const int t = k0 + tid;
    Bs[tid] = t < T_len ? key_bias[static_cast<long long>(b) * T_len + t] : 0.f;
  }

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int m = 0; m < NO; ++m) dk_acc[m] = dv_acc[m] = 0.f;
  const bool key_ok = k0 + row < T_len;

  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    __syncthreads();  // the previous query tile is consumed; K, V in place
    for (int i = tid; i < BQ * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, t = q0 + r;
      const bool ok = t < T_len;
      Qs[r * LD + d] = ok ? qb[t * qs.t + d] : 0.f;
      Ds[r * LD + d] = ok ? db[t * ds.t + d] : 0.f;
    }
    if (tid < BQ) {
      const int t = q0 + tid;
      Ls[tid] = t < T_len ? lse_b[t] : 0.f;
      Dd[tid] = t < T_len ? dsum_b[t] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for key `row` against queries part + 4j
    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
    const float* krow = Ks + row * LD;
    const float* vrow = Vs + row * LD;
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j] = fmaf(kv, Qs[(part + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(vv, Ds[(part + 4 * j) * LD + d], dp[j]);
      }
    }
    const float bias = Bs[row];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int qc = part + 4 * j;
      float pk = 0.f, dsv = 0.f;
      if (key_ok && q0 + qc < T_len) {
        const float lq = Ls[qc];
        const float p = expf((s[j] * sm_scale + bias - lq) - (lq < kNoKeyLse ? log_T : 0.f));
        bool keep = true;
        if (drop.thresh) keep = fs2::dropout_bits(key, q0 + qc, k0 + row) >= drop.thresh;
        const float dprob = keep ? dp[j] * drop.keep_scale : 0.f;
        pk = keep ? p * drop.keep_scale : 0.f;
        dsv = p * (dprob - Dd[qc]);
      }
      PK[row * LP + qc] = pk;
      SS[row * LP + qc] = dsv;
    }
    __syncthreads();  // the tile's kept P and dS are in shared memory

    // dV[row] += PK[row] . dO,  dK[row] += dS[row] . Q
    const float* pkrow = PK + row * LP;
    const float* ssrow = SS + row * LP;
#pragma unroll 2
    for (int qc = 0; qc < BQ; ++qc) {
      const float pk = pkrow[qc], dsv = ssrow[qc];
      const float* dorow = Ds + qc * LD + part;
      const float* qrow = Qs + qc * LD + part;
#pragma unroll
      for (int m = 0; m < NO; ++m) {
        dv_acc[m] = fmaf(pk, dorow[4 * m], dv_acc[m]);
        dk_acc[m] = fmaf(dsv, qrow[4 * m], dk_acc[m]);
      }
    }

    // dQ[query row] += sm_scale * dS[:, row] . K
    const int tq = q0 + row;
    if (tq < T_len) {
      float acc[NO];
#pragma unroll
      for (int m = 0; m < NO; ++m) acc[m] = 0.f;
#pragma unroll 2
      for (int kr = 0; kr < BK; ++kr) {
        const float dsv = SS[kr * LP + row];
        const float* kr_row = Ks + kr * LD + part;
#pragma unroll
        for (int m = 0; m < NO; ++m) acc[m] = fmaf(dsv, kr_row[4 * m], acc[m]);
      }
      float* dqrow = dq_b + static_cast<long long>(tq) * DH + part;
#pragma unroll
      for (int m = 0; m < NO; ++m) atomicAdd(dqrow + 4 * m, acc[m] * sm_scale);
    }
  }

  if (key_ok) {
    const long long off = (bh * T_len + k0 + row) * DH + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) {
      dk[off + 4 * m] = dk_acc[m] * sm_scale;
      dv[off + 4 * m] = dv_acc[m];
    }
  }
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *o;
  const float *bias;
  int* kv_end;
  const float* lse;
  float* dsum;
  float* dq_acc;
  void *dk, *dv;
  int B, H, T_len;
  Strides qs, ks, vs, ds, os;
  float sm_scale;
  Dropout drop;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch_prepass(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.T_len;
  bwd_prepass<T, DH><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.dout), static_cast<const T*>(a.o), a.H, a.T_len, a.ds, a.os,
      a.dsum, a.dq_acc, rows);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  using namespace f32_bwd;
  cudaError_t err = launch_prepass<float, DH>(a);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_floats<DH>() * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per process
      attention_bwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T_len + BK - 1) / BK, a.H, a.B);
  attention_bwd_f32<DH><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.bias, a.kv_end,
      a.lse, a.dsum, a.dq_acc, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T_len,
      a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.drop);
  return cudaGetLastError();
}

template <int DH, bool DROP>
cudaError_t launch_tc(const Args& a) {
  using namespace tc_bwd;
  cudaError_t err = launch_prepass<bf16, DH>(a);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per process
      attention_bwd_tc<DH, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T_len + BK - 1) / BK, a.H, a.B);
  attention_bwd_tc<DH, DROP><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.bias, a.kv_end,
      a.lse, a.dsum, a.dq_acc, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.T_len,
      a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.drop);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// Strides are in elements; for bf16 every row of q, k, v and do starts on
// 16 bytes (the wrapper checks); dk, dv, lse are contiguous. kv_end, dsum
// and dq_acc are scratch (contiguous) that the pre-pass kernels fill:
// kv_end[b], D = rowsum(dO * O), and dq_acc zeroed. Launches the two
// pre-passes and the kernel on `stream`. `seed` may be null when
// thresh == 0. Returns a cudaError_t code.
extern "C" int attention_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* o, const void* key_bias,
                             void* kv_end, const void* lse, void* dsum, const void* seed,
                             void* dq_acc, void* dk, void* dv, int B, int H, int T_len, int dh,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long d_sb, long long d_sh, long long d_st,
                             long long o_sb, long long o_sh, long long o_st,
                             float sm_scale, long long thresh, float keep_scale,
                             int row_offset, int head_offset, int heads_total,
                             void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > 65536 || thresh < 0 || thresh > 0xffffffffLL ||
      (thresh > 0 && seed == nullptr) || kv_end == nullptr || row_offset < 0 ||
      head_offset < 0 || head_offset + H > heads_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, o, static_cast<const float*>(key_bias),
               static_cast<int*>(kv_end), static_cast<const float*>(lse),
               static_cast<float*>(dsum), static_cast<float*>(dq_acc), dk, dv, B, H,
               T_len, Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
               Strides{v_sb, v_sh, v_st}, Strides{d_sb, d_sh, d_st},
               Strides{o_sb, o_sh, o_st}, sm_scale,
               Dropout{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale,
                       row_offset, head_offset, heads_total},
               static_cast<cudaStream_t>(stream)};
  const bool dropout = thresh > 0;
  if ((dtype != fs2::kFloat32 && dtype != fs2::kBFloat16) || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = fs2::attn::launch_kv_end(a.bias, B, T_len, a.kv_end, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == fs2::kFloat32 && dh == 64) return launch_f32<64>(a);
  if (dtype == fs2::kFloat32 && dh == 128) return launch_f32<128>(a);
  if (dtype == fs2::kBFloat16 && dh == 64)
    return dropout ? launch_tc<64, true>(a) : launch_tc<64, false>(a);
  if (dtype == fs2::kBFloat16 && dh == 128)
    return dropout ? launch_tc<128, true>(a) : launch_tc<128, false>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
