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
// bf16, dh 64 and 128 (attention_bwd_tc): FA2's backward on Hopper
// warpgroup products, one launch after two small pre-passes (kv_end, and
// D = rowsum(dO * O) with the f32 dQ buffer zeroed). One block of two
// warpgroups per (128-key tile, head, batch), each warpgroup 64 keys (each
// warp 16), with dK and dV accumulated in registers (f32). K and V stay in
// shared memory; the block loops over 64-row query tiles whose Q, dO, lse
// and D stream through a two-stage cp.async ring. All tiles use the
// 128-byte-swizzled layout of tensor_core.cuh. Per query tile a warpgroup computes S^T = K Q^T and
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
// Built for dh 64, 128, 192 and 256 (ops/attention.py zero-pads every other
// dh up to 256 to the next of them; wider ones take the kernels at the end of
// this header).
//
// dh 192 and 256 (attention_bwd_tc_split): 128 keys a block with dK and dV
// over the whole dh would need 192-256 accumulator registers a thread, so a
// block takes 64 keys and splits every product and every score between its
// two warpgroups, as FA3's head-dim-256 backward does. Per query tile,
// warpgroup w computes S^T and dP^T for the block's 64 keys and the query
// columns [32 w, 32 w + 32) (m64n32, K and V as A, its 32 rows of Q and dO
// as B), runs the exponential, the hash and dS on that half of the tile, and
// writes keep * P / (1 - p) and dS^T as bf16 to two shared [key][query]
// tiles; after one barrier over the block it computes dQ = dS K, dV +=
// (keep P)^T dO and dK += dS^T Q on its own half of the columns, both
// operands from shared memory (dQ's products committed first, so its
// atomics overlap dK's and dV's). Warpgroup w owns columns: at 256 the
// 64-wide blocks 2w and 2w + 1 (one m64n128 a k-step); at 192 block w and
// the half [32 w, 32 w + 32) of block 2 (m64n64 + m64n32), so no block is
// computed twice and no block is padded. Each warpgroup's share is chosen by
// address arithmetic: nvcc 12.9 crashes on a wgmma inside a branch on the
// warpgroup index. Issued per (key tile, query tile): S^T, dP^T, dV, dK and
// dQ once each, 5 products for the function's 5 (1.0x). Shared memory a
// block: 162 KB at dh 192, 210 KB at 256. Registers: dK and dV W floats a
// thread together (96 at 192, 128 at 256, W = dh / 2), S^T and dP^T 32, dQ
// 48 at 192 and, in two 64-column parts, 32 at 256 (split_products); ptxas
// (nvcc 12.9): 235 registers at 192, 247 and 255 (with dropout) at 256, no
// spill. attention_bwd_tc_wide run as one group of the whole dh would do
// the same work, but loads K, Q and dO twice (as chunks and as group tiles)
// and holds two barriers a chunk: 1.22-1.28x this kernel's time on the card
// (tools/bwd_split_vs_wide.py, PERF.md), so both stay.
//
// f32 (attention_bwd_f32): the CUDA-core kernel of the f32 card-vs-CPU
// checks (rel-L2 1e-5): one block of 256 threads per (64-key tile, head,
// batch), four threads per key row, Q, dO, lse and D staged per 64-row query
// tile (32 above dh 128), f32 FMA throughout, dQ by atomicAdd, the same
// kv_end skip.
//
// Wide head dims (attention_common.cuh wide_dh, as in attention_fwd.cu):
// attention_bwd_tc_wide and attention_bwd_f32_wide. A block takes 64 keys
// and one group of NG columns of dK, dV and dQ, blockIdx.x = key tile *
// groups + group, NG = attention_common.cuh group_width(bf16, dh, true): in
// bf16 256 where 256 divides dh, else 192 where 192 does (dh 384: two
// groups, each warpgroup's 96 columns as at dh 192), else 128; in f32 128.
// S^T = K Q^T and dP^T = V dO^T stream over the full dh in 64-wide chunks
// of K, V, Q and dO (a two-stage ring in bf16) into the same
// registers; the group's columns of K stay in shared memory for dQ = dS K,
// and those of Q and dO arrive once a query tile for dK and dV. In bf16 the
// two warpgroups split the work as the dh 192/256 kernel does: each streams
// S^T and dP^T for its 32 query columns and owns NG / 2 of the group's
// columns of dK, dV and dQ, with the kept P^T and dS^T in shared memory
// between them. D = rowsum(dO * O) comes from the pre-pass over the full dh
// (bwd_prepass with DH = 0); dQ goes into the f32 buffer's group columns by
// atomicAdd. The mask is regenerated per (row, col), so every group drops
// the same entries. Shared memory a block: bf16 177.5 KB at NG 256, 153.5
// KB at 192, 129.5 KB at 128; f32 130 KB. The cost left: every group
// recomputes S^T and dP^T over the full dh (one tile of it fits neither
// shared memory nor registers), so the blocks of a (b, h) issue
// 4 T^2 dh x groups + 6 T^2 dh operations for the function's 10 T^2 dh:
// 1.4x at dh 384 (two groups of 192) and at 512 (two of 256), 1.8x at 768
// (three of 256). A three-stage ring loaded two chunks ahead (one barrier a
// chunk), and dK's and dV's products left running into the next tile, were
// both slower on the card (PERF.md). ptxas (nvcc 12.9): NG 128 220-222
// registers and NG 192 252-254, no spill; NG 256 255 and 108-116 bytes of
// spill, which the SASS shows to be the group tiles' load addresses, stored
// once before the query-tile loop and reloaded once a query tile, none
// inside the chunk or product loops.

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

// dK = dV = 0 for a block's rows [k0, k0 + rows) below T, in W columns from
// col0 of rows `ld` elements long (16-byte stores)
template <int W, int THREADS, typename T>
__device__ __forceinline__ void zero_cols(T* dk, T* dv, long long row_base, int k0, int rows,
                                          int T_len, int tid, int ld, int col0) {
  constexpr int CH = W * sizeof(T) / 16;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int t = k0 + i / CH;
    if (t >= T_len) continue;
    const long long off =
        ((row_base + t) * ld + col0) * static_cast<long long>(sizeof(T)) / 16 + i % CH;
    reinterpret_cast<uint4*>(dk)[off] = z;
    reinterpret_cast<uint4*>(dv)[off] = z;
  }
}

// ... over whole rows of DH
template <int DH, int THREADS, typename T>
__device__ __forceinline__ void zero_rows(T* dk, T* dv, long long row_base, int k0, int rows,
                                          int T_len, int tid) {
  zero_cols<DH, THREADS>(dk, dv, row_base, k0, rows, T_len, tid, DH, 0);
}

// Pre-pass: D = rowsum(dO * O) per (b, h, t) row, and that row of dq_acc
// zeroed; one warp per row. DH = 0: the head dim is the runtime `dh` (a
// wide one).
template <typename T, int DH>
__global__ void __launch_bounds__(256)
bwd_prepass(const T* __restrict__ dout, const T* __restrict__ o, int H, int T_len,
            Strides ds, Strides os, float* __restrict__ dsum, float* __restrict__ dq_acc,
            long long rows, int dh) {
  const long long r = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int t = static_cast<int>(r % T_len);
  const long long bh = r / T_len;
  const long long h = bh % H, b = bh / H;
  const T* drow = dout + b * ds.b + h * ds.h + t * ds.t;
  const T* orow = o + b * os.b + h * os.h + t * os.t;
  const int width = DH > 0 ? DH : dh;
  float acc = 0.f;
  auto add = [&](int d) {
    acc = fmaf(fs2::to_f32(drow[d]), fs2::to_f32(orow[d]), acc);
    dq_acc[r * width + d] = 0.f;
  };
  if constexpr (DH > 0) {
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) add(lane + 32 * i);
  } else {
    for (int d = lane; d < dh; d += 32) add(d);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[r] = acc;
}

// -- bf16: tensor cores -------------------------------------------------------

namespace tc_bwd {

constexpr int BQ = 64;        // query rows per tile
constexpr int THREADS = 256;  // two warpgroups of 4 warps x 16 key rows

// dh 64 and 128: a block takes 128 keys, 64 a warpgroup, each with its
// keys' whole dK and dV in registers.
template <int DH>
struct Tiling {
  static constexpr int BK = 128;  // keys per block
  // 1024 bytes to align the tiles to the swizzle period; K and V tiles, two
  // stages of Q and dO tiles, the dS^T tile (bf16); two stages of lse and D
  static constexpr size_t SMEM = 1024 + (2 * BK * DH + 4 * BQ * DH + BK * BQ) * sizeof(bf16) +
                                 4 * BQ * sizeof(float);
};

// Above dh 128 a block takes 64 keys and its two warpgroups split the work
// of every (key tile, query tile) between them: warpgroup w computes S^T
// and dP^T for the query columns [32 w, 32 w + 32) of the tile (m64n32) and
// runs their exponential, hash and dS, writing keep * P / (1 - p) and dS^T
// to two shared [key][query] tiles; after one barrier it computes dV, dK
// and dQ on its own half of the columns, reading those tiles as A.
constexpr int SPLIT_BK = 64;  // keys per block
constexpr int HALF_Q = BQ / 2;  // query columns of S^T and dP^T a warpgroup

// dh 192 and 256: K and V tiles, two stages of Q and dO tiles, the kept-P^T
// and dS^T tiles (bf16), two stages of lse and D, and 1024 bytes to align
// the tiles to the swizzle period
template <int DH>
struct SplitTiling {
  static constexpr size_t SMEM =
      1024 + (2 * SPLIT_BK * DH + 4 * BQ * DH + 2 * SPLIT_BK * BQ) * sizeof(bf16) +
      4 * BQ * sizeof(float);
};

// A wide head dim (attention_common.cuh wide_dh): 64 keys and one group of
// NG = 128, 192 or 256 columns of dK, dV and dQ a block (blockIdx.x = key
// tile * groups + group), split between the warpgroups as above. S^T =
// K Q^T and dP^T = V dO^T stream over dh in 64-wide chunks of K, V, Q and
// dO through a two-stage ring; the group's columns of K stay, and those of
// Q and dO arrive per query tile, for dK, dV and dQ.
template <int NG>
struct WideTiling {
  static constexpr int CW = fs2::attn::CHUNK;
  static constexpr int STAGE = (2 * SPLIT_BK + 2 * BQ) * CW;  // K, V, Q, dO chunks of a stage
  // 1024 bytes to align the tiles to the swizzle period; the K group tile,
  // the Q and dO group tiles, two chunk stages, the kept-P^T and dS^T tiles
  // (bf16); lse, D
  static constexpr size_t SMEM = 1024 +
                                 (SPLIT_BK * NG + 2 * BQ * NG + 2 * STAGE + 2 * SPLIT_BK * BQ) *
                                     sizeof(bf16) +
                                 2 * BQ * sizeof(float);
};

// Column n-block n (8 columns) of the W columns of dK, dV and dQ that
// warpgroup wg owns, W = DH / 2 (or NG / 2): W 128, the 64-wide column
// blocks 2 wg and 2 wg + 1; W 64 (a group of 128), block wg; W 96 (dh 192,
// a group of 192), block wg and the half [32 wg, 32 wg + 32) of block 2, so
// no block is computed twice.
template <int W>
__device__ __forceinline__ int half_col(int wg, int n) {
  if constexpr (W == 96) return n < 8 ? 64 * wg + 8 * n : 128 + 32 * wg + 8 * (n - 8);
  return W * wg + 8 * n;
}

// d += A B over warpgroup wg's W columns for one k-step: A the descriptor
// `a` (TA as wgmma_ss_n64), B read transposed from the k-step's first row
// `b` of a 128-byte-swizzled MN-major tile of R rows, its 64-wide column
// blocks R * 64 elements apart. One m64n128 product at W 128, m64n64 at 64,
// m64n64 + m64n32 at 96. Each warpgroup's share is picked by its address,
// never by a branch around a wgmma (nvcc 12.9 crashes on one).
template <int W, int TA, int R>
__device__ __forceinline__ void wgmma_half_cols(float (&d)[W / 8][4], uint64_t a, const bf16* b,
                                                int wg) {
  using namespace fs2::tc;
  if constexpr (W == 128) {
    wgmma_ss_n128<TA, 1>(d, a, sw128_desc(b + 2 * wg * R * 64, R * 128, 1024));
  } else if constexpr (W == 64) {
    wgmma_ss_n64<TA, 1>(d, a, sw128_desc(b + wg * R * 64, R * 128, 1024));
  } else {
    static_assert(W == 96, "a warpgroup's columns: 64, 96 or 128");
    wgmma_ss_n64<TA, 1>(*reinterpret_cast<float(*)[8][4]>(&d[0]), a,
                        sw128_desc(b + wg * R * 64, R * 128, 1024));
    wgmma_ss_n32<TA, 1>(*reinterpret_cast<float(*)[4][4]>(&d[8]), a,
                        sw128_desc(b + 2 * R * 64 + 32 * wg, R * 128, 1024));
  }
}

}  // namespace tc_bwd

// P^T, the keep mask and dS^T = P^T * (keep * dP^T / (1 - p) - D) on the f32
// accumulators of S^T (`sp`) and dP^T (`dpt`) for this thread's two key
// rows and NB n-blocks of query columns c0 + 8 n + ..: `sp` becomes
// keep * P / (1 - p) and `dpt` dS^T. Lt, Dt: the query tile's lse and D.
template <bool DROP, int NB>
__device__ __forceinline__ void bwd_scores(float (&sp)[NB][4], float (&dpt)[NB][4],
                                           const int (&kr)[2], const float (&kbias)[2],
                                           const uint32_t (&kx)[2], const float* Lt,
                                           const float* Dt, int q0, int c0, int T_len,
                                           float sm_scale, float log2_T, const Dropout& drop,
                                           int t4) {
  using namespace fs2::tc;
  // the query tile's part of the dropout hash (common.cuh dropout_bits): the
  // high halves of its rows and of these keys (a 16-row group)
  const uint32_t hq = DROP ? fs2::dropout_high(q0, kr[0]) : 0u;
  const uint32_t kxt[2] = {kx[0] ^ hq, kx[1] ^ hq};
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int c = c0 + n * 8 + 2 * t4 + (e & 1);
      const int qrow = q0 + c;
      float p = 0.f;
      if (kr[r] < T_len && qrow < T_len) {
        const float lq = Lt[c];
        const float x = fmaf(sp[n][e], sm_scale, kbias[r]);
        p = fast_exp2((x - lq) * kLog2e - (lq < kNoKeyLse ? log2_T : 0.f));
      }
      const bool keep =
          !DROP || fs2::mix32((static_cast<uint32_t>(qrow) << 16) ^ kxt[r]) >= drop.thresh;
      sp[n][e] = keep ? p * drop.keep_scale : 0.f;
      dpt[n][e] = p * ((keep ? dpt[n][e] * drop.keep_scale : 0.f) - Dt[c]);
    }
  }
}

// One query tile of the dh 64/128 backward once S^T and dP^T for this
// thread's two key rows are in `sp` and `dpt` (query columns q0 + ..):
// bwd_scores, then keep * P / (1 - p) and dS^T as the bf16 A fragments
// `pa`, `sa` of dV's and dK's products.
template <bool DROP>
__device__ __forceinline__ void bwd_fragments(float (&sp)[tc_bwd::BQ / 8][4],
                                              float (&dpt)[tc_bwd::BQ / 8][4],
                                              uint32_t (&pa)[tc_bwd::BQ / 16][4],
                                              uint32_t (&sa)[tc_bwd::BQ / 16][4],
                                              const int (&kr)[2], const float (&kbias)[2],
                                              const uint32_t (&kx)[2], const float* Lt,
                                              const float* Dt, int q0, int T_len, float sm_scale,
                                              float log2_T, const Dropout& drop, int t4) {
  using namespace fs2::tc;
  constexpr int BQ = tc_bwd::BQ;
  bwd_scores<DROP, BQ / 8>(sp, dpt, kr, kbias, kx, Lt, Dt, q0, 0, T_len, sm_scale, log2_T, drop,
                           t4);
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    c_to_a(pa[kk], sp[2 * kk], sp[2 * kk + 1]);
    c_to_a(sa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
  }
}

// dS^T (the A fragments `sa`) to shared memory, [key][query] in the
// 128-byte-swizzled layout of a BK-row tile: this warp's 16 key rows from
// kw * 16
template <int BK>
__device__ __forceinline__ void store_ds(bf16* Ss, const uint32_t (&sa)[tc_bwd::BQ / 16][4],
                                         int kw, int g, int t4) {
  using namespace fs2::tc;
  constexpr int NB_S = tc_bwd::BQ / 8;
  const int row = kw * 16 + g;
#pragma unroll
  for (int n = 0; n < NB_S; ++n) {
    *reinterpret_cast<uint32_t*>(Ss + sw128<BK>(row, n) + 2 * t4) = sa[n >> 1][(n & 1) * 2];
    *reinterpret_cast<uint32_t*>(Ss + sw128<BK>(row + 8, n) + 2 * t4) =
        sa[n >> 1][(n & 1) * 2 + 1];
  }
}

// This thread's NB n-blocks of a score tile (f32 accumulators of two key
// rows, query columns c0 + 8 n + ..) rounded to bf16 into the
// 128-byte-swizzled [key][query] tile `St` of BK rows (one 64-wide column
// block): this warp's 16 key rows from kw * 16.
template <int BK, int NB>
__device__ __forceinline__ void store_scores(bf16* St, const float (&s)[NB][4], int kw, int c0,
                                             int g, int t4) {
  using namespace fs2::tc;
  const int row = kw * 16 + g;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int chunk = c0 / 8 + n;
    *reinterpret_cast<uint32_t*>(St + sw128<BK>(row, chunk) + 2 * t4) =
        pack_bf16(s[n][0], s[n][1]);
    *reinterpret_cast<uint32_t*>(St + sw128<BK>(row + 8, chunk) + 2 * t4) =
        pack_bf16(s[n][2], s[n][3]);
  }
}

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
  static_assert(DH == 64 || DH == 128, "dh 64 and 128; above, attention_bwd_tc_split");
  constexpr int BK = Tiling<DH>::BK;
  constexpr int NB_ACC = DH / 8;   // dK, dV accumulator n-blocks a thread: all of dh
  constexpr int KSTEPS = DH / 16;  // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int NB_S = BQ / 8;     // n-blocks of S^T (query columns)
  constexpr int NB_Q = 8;          // n-blocks of 64 columns of dQ
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
  const int wg = warp >> 2;
  const int kw = warp;  // this warp's 16 key rows of the block: keys 64 * wg ..
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
    kr[r] = k0 + kw * 16 + g + 8 * r;
    kbias[r] = kr[r] < T_len ? key_bias[static_cast<long long>(b) * T_len + kr[r]] : 0.f;
    kx[r] = (static_cast<uint32_t>(kr[r]) & 0xffffu) ^ key;
  }
  const float log2_T = log2f(static_cast<float>(T_len));

  float dka[NB_ACC][4], dva[NB_ACC][4];
#pragma unroll
  for (int n = 0; n < NB_ACC; ++n)
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

    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
    bwd_fragments<DROP>(sp, dpt, pa, sa, kr, kbias, kx, Lt, Dt, q0, T_len, sm_scale, log2_T,
                        drop, t4);

    // dV += (keep P / (1 - p))^T dO and dK += dS^T Q, A from registers, B
    // (dO, Q) from shared memory read transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs_cols<DH, BQ>(dva, pa[kk], Ot + kk * 16 * 64);
      wgmma_rs_cols<DH, BQ>(dka, sa[kk], Qt + kk * 16 * 64);
    }
    wgmma_commit();

    // dS^T (bf16) to shared memory, [key][query] in the 128-byte-swizzled
    // layout, while the products run
    store_ds<BK>(Ss, sa, kw, g, t4);
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
    for (int n = 0; n < NB_ACC; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// One query tile's products once the block's kept-P^T and dS^T tiles are
// in `Ps`, `Ss` (and a barrier has passed): warpgroup wg's W columns of
// dQ = dS K (A = dS^T read transposed, B the K tile `Kt` of BK rows), added
// to the f32 buffer's rows q0 + .. of `ld` floats at columns col0 + .. by
// atomicAdd, and of dV += P^T dO and dK += dS^T Q (A = the tiles as
// stored, B the dO and Q tiles `Ot`, `Qt` of BQ rows). dQ's first part is
// committed before dK's and dV's products, so its atomics overlap them. At
// W 128 dQ goes in two 64-column parts, the second after dK and dV: 32 of
// its accumulators live beside dK's and dV's 128 instead of 64, which keeps
// the kernel from spilling. Returns when all are done.
template <int W, int BK>
__device__ __forceinline__ void split_products(float (&dka)[W / 8][4], float (&dva)[W / 8][4],
                                               const bf16* Ps, const bf16* Ss, const bf16* Kt,
                                               const bf16* Qt, const bf16* Ot, float* dq_b,
                                               long long ld, int col0, int q0, int T_len,
                                               float sm_scale, int wg, int kw, int g, int t4) {
  using namespace fs2::tc;
  using namespace tc_bwd;
  constexpr int PARTS = W == 128 ? 2 : 1;
  constexpr int NP = W / PARTS / 8;  // dQ accumulator n-blocks of a part
  // part j of dQ: its products, then its atomics once they are done
  auto dq_products = [&](float (&dqa)[NP][4], int j) {
#pragma unroll
    for (int n = 0; n < NP; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = sw128_desc(Ss + kk * 16 * 64, BK * 128, 1024);
      if constexpr (PARTS == 2)  // the 64-wide column block 2 wg + j
        wgmma_ss_n64<1, 1>(dqa, a,
                           sw128_desc(Kt + kk * 16 * 64 + (2 * wg + j) * BK * 64, BK * 128, 1024));
      else
        wgmma_half_cols<W, 1, BK>(dqa, a, Kt + kk * 16 * 64, wg);
    }
    wgmma_commit();
  };
  auto dq_atomics = [&](const float (&dqa)[NP][4], int j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = q0 + kw * 16 + g + 8 * r;
      if (qrow >= T_len) continue;
      float* dst = dq_b + qrow * ld + col0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NP; ++n)  // one vector add per column pair (sm_90)
        atomicAdd(reinterpret_cast<float2*>(dst + half_col<W>(wg, NP * j + n)),
                  make_float2(dqa[n][2 * r] * sm_scale, dqa[n][2 * r + 1] * sm_scale));
    }
  };
  {
    float dqa[NP][4];
    dq_products(dqa, 0);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_half_cols<W, 0, BQ>(dva, sw128_desc(Ps + kk * 16, 16, 1024), Ot + kk * 16 * 64, wg);
      wgmma_half_cols<W, 0, BQ>(dka, sw128_desc(Ss + kk * 16, 16, 1024), Qt + kk * 16 * 64, wg);
    }
    wgmma_commit();
    wgmma_wait<1>();  // dQ's products are done; dK's and dV's run on
    dq_atomics(dqa, 0);
  }
  if constexpr (PARTS == 2) {
    float dqa[NP][4];
    dq_products(dqa, 1);
    wgmma_wait<0>();
    dq_atomics(dqa, 1);
  }
  wgmma_wait<0>();
}

// dK (times sm_scale) and dV of this thread's two key rows `kr` on
// warpgroup wg's W columns, from column col0 of rows `ld` elements long
template <int W>
__device__ __forceinline__ void store_split_dkdv(bf16* dk, bf16* dv, const float (&dka)[W / 8][4],
                                                 const float (&dva)[W / 8][4],
                                                 const int (&kr)[2], long long row_base,
                                                 long long ld, int col0, int T_len,
                                                 float sm_scale, int wg, int t4) {
  using namespace fs2::tc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= T_len) continue;
    const long long off = (row_base + kr[r]) * ld + col0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      const int col = tc_bwd::half_col<W>(wg, n);
      *reinterpret_cast<uint32_t*>(dk + off + col) =
          pack_bf16(dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + off + col) = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(tc_bwd::THREADS, 1)
attention_bwd_tc_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                       const float* __restrict__ lse, const float* __restrict__ dsum,
                       float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int T_len, Strides qs, Strides ks, Strides vs, Strides ds,
                       float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using namespace tc_bwd;
  static_assert(DH == 192 || DH == 256, "dh 192 and 256");
  constexpr int BK = SPLIT_BK;
  constexpr int W = DH / 2;        // columns of dK, dV and dQ a warpgroup
  constexpr int KSTEPS = DH / 16;  // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int NB_S = HALF_Q / 8;  // n-blocks of this warpgroup's S^T and dP^T
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* Vs = Ks + BK * DH;
  bf16* Qs = Vs + BK * DH;      // [2][BQ * DH]
  bf16* Os = Qs + 2 * BQ * DH;  // [2][BQ * DH], the dO tiles
  bf16* Ps = Os + 2 * BQ * DH;  // [BK][BQ], keep * P^T / (1 - p)
  bf16* Ss = Ps + BK * BQ;      // [BK][BQ], dS^T
  float* Ls = reinterpret_cast<float*>(Ss + BK * BQ);  // [2][BQ]
  float* Dd = Ls + 2 * BQ;                             // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, kw = warp & 3;  // this warp's 16 keys, in either warpgroup
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = wg * HALF_Q;  // this warpgroup's query columns of a tile's S^T and dP^T
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
    kr[r] = k0 + kw * 16 + g + 8 * r;
    kbias[r] = kr[r] < T_len ? key_bias[static_cast<long long>(b) * T_len + kr[r]] : 0.f;
    kx[r] = (static_cast<uint32_t>(kr[r]) & 0xffffu) ^ key;
  }
  const float log2_T = log2f(static_cast<float>(T_len));

  float dka[W / 8][4], dva[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_qt = (T_len + BQ - 1) / BQ;
  for (int i = 0; i < n_qt; ++i) {
    cp_async_wait<0>();  // query tile i (and K, V) landed
    fence_async_shared();
    __syncthreads();  // ... for every thread; tile i - 1's products are done with Ps, Ss
                      // and with the Q, dO stage that tile i + 1 refills
    if (i + 1 < n_qt) load_q((i + 1) & 1, (i + 1) * BQ);
    cp_async_commit();
    const bf16* Qt = Qs + (i & 1) * BQ * DH;
    const bf16* Ot = Os + (i & 1) * BQ * DH;
    const float* Lt = Ls + (i & 1) * BQ;
    const float* Dt = Dd + (i & 1) * BQ;
    const int q0 = i * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the block's 64 keys and this
    // warpgroup's 32 query columns (m64n32, all operands from shared memory)
    float sp[NB_S][4], dpt[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = dpt[n][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = (kk & 3) * 16;  // within the 64-wide column block kk / 4
      const int kv_off = (kk >> 2) * BK * 64 + col;
      const int q_off = (kk >> 2) * BQ * 64 + c0 * 64 + col;
      wgmma_ss_n32(sp, sw128_desc(Ks + kv_off, 16, 1024), sw128_desc(Qt + q_off, 16, 1024));
      wgmma_ss_n32(dpt, sw128_desc(Vs + kv_off, 16, 1024), sw128_desc(Ot + q_off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();

    bwd_scores<DROP, NB_S>(sp, dpt, kr, kbias, kx, Lt, Dt, q0, c0, T_len, sm_scale, log2_T,
                           drop, t4);
    store_scores<BK, NB_S>(Ps, sp, kw, c0, g, t4);
    store_scores<BK, NB_S>(Ss, dpt, kw, c0, g, t4);
    fence_async_shared();
    __syncthreads();  // the tile's kept P^T and dS^T are whole in shared memory

    split_products<W, BK>(dka, dva, Ps, Ss, Ks, Qt, Ot, dq_b, DH, 0, q0, T_len, sm_scale, wg, kw,
                          g, t4);
  }

  store_split_dkdv<W>(dk, dv, dka, dva, kr, row_base, DH, 0, T_len, sm_scale, wg, t4);
}

template <int NG, bool DROP>
__global__ void __launch_bounds__(tc_bwd::THREADS, 1)
attention_bwd_tc_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int T_len, int dh, Strides qs, Strides ks, Strides vs, Strides ds,
                      float sm_scale, Dropout drop) {
  using namespace fs2::tc;
  using namespace tc_bwd;
  using Tile = WideTiling<NG>;
  constexpr int BK = SPLIT_BK, CW = Tile::CW;
  constexpr int W = NG / 2;         // columns of the group a warpgroup owns
  constexpr int NB_S = HALF_Q / 8;  // n-blocks of this warpgroup's S^T and dP^T
  extern __shared__ unsigned char smem_raw[];
  bf16* Kg = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* Qg = Kg + BK * NG;      // [BQ * NG]
  bf16* Og = Qg + BQ * NG;      // [BQ * NG], dO
  bf16* Ch = Og + BQ * NG;      // [2][STAGE]: K, V chunks [BK * CW], Q, dO chunks [BQ * CW]
  bf16* Ps = Ch + 2 * Tile::STAGE;                     // [BK][BQ], keep * P^T / (1 - p)
  bf16* Ss = Ps + BK * BQ;                             // [BK][BQ], dS^T
  float* Ls = reinterpret_cast<float*>(Ss + BK * BQ);  // [BQ]
  float* Dd = Ls + BQ;                                 // [BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, kw = warp & 3;  // this warp's 16 keys, in either warpgroup
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = wg * HALF_Q;  // this warpgroup's query columns of a tile's S^T and dP^T
  const int n_groups = dh / NG;
  const int g0 = (blockIdx.x % n_groups) * NG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = (blockIdx.x / n_groups) * BK;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const long long row_base = bh * T_len;

  if (k0 >= min(max(kv_end[b], 1), T_len)) {
    zero_cols<NG, THREADS>(dk, dv, row_base, k0, BK, T_len, tid, dh, g0);
    return;
  }

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + row_base;
  const float* dsum_b = dsum + row_base;
  float* dq_b = dq_acc + row_base * dh;
  const int n_chunks = dh / CW;
  const int n_qt = (T_len + BQ - 1) / BQ;
  const int n_steps = n_qt * n_chunks;

  // step st: chunk st % n_chunks of the K and V tiles and of query tile
  // st / n_chunks's Q and dO tiles, into stage st & 1
  auto load_chunk = [&](int st) {
    const int i = st / n_chunks, c = st - i * n_chunks;
    bf16* stage = Ch + (st & 1) * Tile::STAGE;
    load_tile<BK, CW, THREADS>(stage, kb + c * CW, ks.t, k0, T_len, tid);
    load_tile<BK, CW, THREADS>(stage + BK * CW, vb + c * CW, vs.t, k0, T_len, tid);
    load_tile<BQ, CW, THREADS>(stage + 2 * BK * CW, qb + c * CW, qs.t, i * BQ, T_len, tid);
    load_tile<BQ, CW, THREADS>(stage + (2 * BK + BQ) * CW, db + c * CW, ds.t, i * BQ, T_len,
                               tid);
  };
  // query tile i's group columns of Q and dO, its lse and D
  auto load_group = [&](int i) {
    const int q0 = i * BQ;
    load_tile<BQ, NG, THREADS>(Qg, qb + g0, qs.t, q0, T_len, tid);
    load_tile<BQ, NG, THREADS>(Og, db + g0, ds.t, q0, T_len, tid);
    const int r = tid & (BQ - 1);
    const bool ok = q0 + r < T_len;
    if (tid < BQ)
      cp_async4(Ls + r, lse_b + (ok ? q0 + r : 0), ok);
    else if (tid < 2 * BQ)
      cp_async4(Dd + r, dsum_b + (ok ? q0 + r : 0), ok);
  };

  load_tile<BK, NG, THREADS>(Kg, kb + g0, ks.t, k0, T_len, tid);
  load_chunk(0);
  cp_async_commit();

  // this thread's two key rows: bias, validity, dropout hash prefix
  int kr[2];
  float kbias[2];
  uint32_t kx[2];
  const uint32_t key = DROP ? drop.key(b, h) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = k0 + kw * 16 + g + 8 * r;
    kbias[r] = kr[r] < T_len ? key_bias[static_cast<long long>(b) * T_len + kr[r]] : 0.f;
    kx[r] = (static_cast<uint32_t>(kr[r]) & 0xffffu) ^ key;
  }
  const float log2_T = log2f(static_cast<float>(T_len));

  float dka[W / 8][4], dva[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0, st = 0; i < n_qt; ++i) {
    const int q0 = i * BQ;
    float sp[NB_S][4], dpt[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = dpt[n][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c, ++st) {
      if (st + 1 < n_steps) load_chunk(st + 1);
      // the group tiles of query tile i: their last readers (tile i - 1's
      // products) finished before the barrier that ended tile i - 1
      if (c == 0) load_group(i);
      cp_async_commit();
      cp_async_wait<1>();  // step st's chunks landed (and, from c = 1, tile i's group tiles)
      fence_async_shared();
      __syncthreads();
      const bf16* stage = Ch + (st & 1) * Tile::STAGE;
      const bf16* Kt = stage;
      const bf16* Vt = stage + BK * CW;
      const bf16* Qt = stage + 2 * BK * CW + c0 * CW;  // this warpgroup's 32 query rows
      const bf16* Ot = stage + (2 * BK + BQ) * CW + c0 * CW;
      // S^T += K Q^T and dP^T += V dO^T over this chunk for this
      // warpgroup's query columns, all from shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) {
        wgmma_ss_n32(sp, sw128_desc(Kt + kk * 16, 16, 1024), sw128_desc(Qt + kk * 16, 16, 1024));
        wgmma_ss_n32(dpt, sw128_desc(Vt + kk * 16, 16, 1024), sw128_desc(Ot + kk * 16, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();  // stage st & 1 is consumed before step st + 2 refills it
    }

    bwd_scores<DROP, NB_S>(sp, dpt, kr, kbias, kx, Ls, Dd, q0, c0, T_len, sm_scale, log2_T,
                           drop, t4);
    store_scores<BK, NB_S>(Ps, sp, kw, c0, g, t4);
    store_scores<BK, NB_S>(Ss, dpt, kw, c0, g, t4);
    fence_async_shared();
    __syncthreads();  // the tile's kept P^T and dS^T are whole in shared memory

    split_products<W, BK>(dka, dva, Ps, Ss, Kg, Qg, Og, dq_b, dh, g0, q0, T_len, sm_scale, wg, kw,
                          g, t4);
    __syncthreads();  // Ps, Ss, Qg, Og and Ls, Dd are consumed before tile i + 1 refills them
  }

  store_split_dkdv<W>(dk, dv, dka, dva, kr, row_base, dh, g0, T_len, sm_scale, wg, t4);
}

// -- f32: CUDA cores ----------------------------------------------------------

namespace f32_bwd {

constexpr int BK = 64;        // keys per block
constexpr int THREADS = 256;  // 4 threads per key (or query) row

// query rows per tile: 64, and 32 above dh 128, where 64 would take 297 KB
// of shared memory at dh 256
template <int DH>
__host__ __device__ constexpr int bq() {
  return DH > 128 ? 32 : 64;
}

template <int DH>
constexpr size_t smem_floats() {
  // K, V tiles and Q, dO tiles padded to DH + 1; P-kept and dS tiles
  // [key][query] padded to BQ + 1; key bias, lse, D.
  return 2 * (BK + bq<DH>()) * (DH + 1) + 2 * BK * (bq<DH>() + 1) + BK + 2 * bq<DH>();
}

// a wide head dim: 32 query rows a tile; K, V, Q and dO chunks padded to 65
// columns, the K group tile and the Q and dO group tiles padded to NG + 1,
// P-kept and dS tiles, key bias, lse, D
constexpr int WIDE_BQ = 32;
template <int NG>
constexpr size_t wide_smem_floats() {
  constexpr int CW = fs2::attn::CHUNK;
  return 2 * (BK + WIDE_BQ) * (CW + 1) + (BK + 2 * WIDE_BQ) * (NG + 1) +
         2 * BK * (WIDE_BQ + 1) + BK + 2 * WIDE_BQ;
}

}  // namespace f32_bwd

// One query tile of the f32 backward once this thread's S^T and dP^T
// entries (key `row`, queries part + 4 j) are in `s` and `dp`: form the kept
// P and dS in shared memory (PK, SS: [key][query], BQ + 1 a row), add this
// thread's NO columns part + 4 m of dV and dK from the dO and Q tiles `Os`,
// `Qs` (LDQ floats a row), and add dQ = sm_scale * dS K from the K tile `Ks`
// (LDK a row) into dq_b's rows of `ld` floats at column col0 + part + 4 m.
// Holds a barrier.
template <int NO, int BQ, int LDQ, int LDK>
__device__ __forceinline__ void f32_bwd_tile(const float (&s)[BQ / 4], const float (&dp)[BQ / 4],
                                             float (&dk_acc)[NO], float (&dv_acc)[NO],
                                             float bias, const float* Ls, const float* Dd,
                                             float* PK, float* SS, const float* Qs,
                                             const float* Os, const float* Ks, float* dq_b,
                                             int ld, int col0, int row, int part, int q0, int k0,
                                             int T_len, bool key_ok, float sm_scale,
                                             float log_T, uint32_t key, const Dropout& drop) {
  constexpr int BK = f32_bwd::BK;
  constexpr int LP = BQ + 1;
  constexpr int NS = BQ / 4;
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
    const float* dorow = Os + qc * LDQ + part;
    const float* qrow = Qs + qc * LDQ + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) {
      dv_acc[m] = fmaf(pk, dorow[4 * m], dv_acc[m]);
      dk_acc[m] = fmaf(dsv, qrow[4 * m], dk_acc[m]);
    }
  }

  // dQ[query row] += sm_scale * dS[:, row] . K
  const int tq = q0 + row;
  if (row < BQ && tq < T_len) {
    float acc[NO];
#pragma unroll
    for (int m = 0; m < NO; ++m) acc[m] = 0.f;
#pragma unroll 2
    for (int kr = 0; kr < BK; ++kr) {
      const float dsv = SS[kr * LP + row];
      const float* kr_row = Ks + kr * LDK + part;
#pragma unroll
      for (int m = 0; m < NO; ++m) acc[m] = fmaf(dsv, kr_row[4 * m], acc[m]);
    }
    float* dqrow = dq_b + static_cast<long long>(tq) * ld + col0 + part;
#pragma unroll
    for (int m = 0; m < NO; ++m) atomicAdd(dqrow + 4 * m, acc[m] * sm_scale);
  }
}

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
  constexpr int BQ = bq<DH>();
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
    f32_bwd_tile<NO, BQ, LD, LD>(s, dp, dk_acc, dv_acc, Bs[row], Ls, Dd, PK, SS, Qs, Ds, Ks,
                                 dq_b, DH, 0, row, part, q0, k0, T_len, key_ok, sm_scale,
                                 log_T, key, drop);
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

// A wide head dim in f32: blockIdx.x = key tile * groups + group, the block's
// columns [NG * group, NG * group + NG) of dK, dV and dQ. Per query tile, S^T
// and dP^T are summed over dh in 64-wide chunks of K, V, Q and dO staged
// one after the other (the same order over d as the kernel above); the
// group's columns of K stay, and those of Q and dO are staged with the
// first chunk, for f32_bwd_tile.
template <int NG>
__global__ void __launch_bounds__(f32_bwd::THREADS)
attention_bwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ key_bias, const int* __restrict__ kv_end,
                       const float* __restrict__ lse, const float* __restrict__ dsum,
                       float* __restrict__ dq_acc, float* __restrict__ dk,
                       float* __restrict__ dv, int T_len, int dh, Strides qs, Strides ks,
                       Strides vs, Strides ds, float sm_scale, Dropout drop) {
  using namespace f32_bwd;
  constexpr int BQ = WIDE_BQ;
  constexpr int CW = fs2::attn::CHUNK;
  constexpr int LC = CW + 1;  // chunk rows
  constexpr int LG = NG + 1;  // group rows
  constexpr int LP = BQ + 1;
  constexpr int NO = NG / 4;  // accumulator columns per thread
  constexpr int NS = BQ / 4;  // score columns per thread
  extern __shared__ float smem[];
  float* Kc = smem;
  float* Vc = Kc + BK * LC;
  float* Qc = Vc + BK * LC;
  float* Oc = Qc + BQ * LC;  // dO chunk
  float* Kg = Oc + BQ * LC;
  float* Qg = Kg + BK * LG;
  float* Og = Qg + BQ * LG;  // dO group columns
  float* PK = Og + BQ * LG;
  float* SS = PK + BK * LP;
  float* Bs = SS + BK * LP;
  float* Ls = Bs + BK;
  float* Dd = Ls + BQ;

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // key row for dK/dV, query row for dQ
  const int part = tid & 3;
  const int n_groups = dh / NG;
  const int g0 = (blockIdx.x % n_groups) * NG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = (blockIdx.x / n_groups) * BK;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;

  if (k0 >= min(max(kv_end[b], 1), T_len)) {
    zero_cols<NG, THREADS>(dk, dv, bh * T_len, k0, BK, T_len, tid, dh, g0);
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
  float* dq_b = dq_acc + bh * T_len * dh;

  for (int i = tid; i < BK * NG; i += THREADS) {
    const int r = i / NG, d = i % NG, t = k0 + r;
    Kg[r * LG + d] = t < T_len ? kb[t * ks.t + g0 + d] : 0.f;
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
    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += CW) {
      __syncthreads();  // the previous chunk (and query tile) is consumed
      for (int i = tid; i < BK * CW; i += THREADS) {
        const int r = i / CW, d = i % CW, t = k0 + r;
        const bool ok = t < T_len;
        Kc[r * LC + d] = ok ? kb[t * ks.t + c0 + d] : 0.f;
        Vc[r * LC + d] = ok ? vb[t * vs.t + c0 + d] : 0.f;
      }
      for (int i = tid; i < BQ * CW; i += THREADS) {
        const int r = i / CW, d = i % CW, t = q0 + r;
        const bool ok = t < T_len;
        Qc[r * LC + d] = ok ? qb[t * qs.t + c0 + d] : 0.f;
        Oc[r * LC + d] = ok ? db[t * ds.t + c0 + d] : 0.f;
      }
      if (c0 == 0) {
        for (int i = tid; i < BQ * NG; i += THREADS) {
          const int r = i / NG, d = i % NG, t = q0 + r;
          const bool ok = t < T_len;
          Qg[r * LG + d] = ok ? qb[t * qs.t + g0 + d] : 0.f;
          Og[r * LG + d] = ok ? db[t * ds.t + g0 + d] : 0.f;
        }
        if (tid < BQ) {
          const int t = q0 + tid;
          Ls[tid] = t < T_len ? lse_b[t] : 0.f;
          Dd[tid] = t < T_len ? dsum_b[t] : 0.f;
        }
      }
      __syncthreads();

      // S^T and dP^T for key `row` against queries part + 4j
      const float* krow = Kc + row * LC;
      const float* vrow = Vc + row * LC;
#pragma unroll 2
      for (int d = 0; d < CW; ++d) {
        const float kv = krow[d], vv = vrow[d];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j] = fmaf(kv, Qc[(part + 4 * j) * LC + d], s[j]);
          dp[j] = fmaf(vv, Oc[(part + 4 * j) * LC + d], dp[j]);
        }
      }
    }
    f32_bwd_tile<NO, BQ, LG, LG>(s, dp, dk_acc, dv_acc, Bs[row], Ls, Dd, PK, SS, Qg, Og, Kg,
                                 dq_b, dh, g0, row, part, q0, k0, T_len, key_ok, sm_scale,
                                 log_T, key, drop);
  }

  if (key_ok) {
    const long long off = (bh * T_len + k0 + row) * dh + g0 + part;
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
  int B, H, T_len, dh;
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
      a.dsum, a.dq_acc, rows, a.dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  using namespace f32_bwd;
  cudaError_t err = launch_prepass<float, DH>(a);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_floats<DH>() * sizeof(float);
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_bwd_f32<DH>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T_len + BK - 1) / BK, a.H, a.B);
  attention_bwd_f32<DH><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.bias, a.kv_end,
      a.lse, a.dsum, a.dq_acc, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T_len,
      a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.drop);
  return cudaGetLastError();
}

// the bf16 kernel of a built dh (both take the same arguments)
template <int DH, bool DROP>
auto bwd_tc_kernel() {
  if constexpr (DH > 128)
    return attention_bwd_tc_split<DH, DROP>;
  else
    return attention_bwd_tc<DH, DROP>;
}

template <int DH, bool DROP>
cudaError_t launch_tc(const Args& a) {
  cudaError_t err = launch_prepass<bf16, DH>(a);
  if (err != cudaSuccess) return err;
  // dh 64, 128: 128 keys a block; 192, 256: 64 keys, the work split between
  // the warpgroups
  constexpr bool SPLIT = DH > 128;
  constexpr int BK = SPLIT ? tc_bwd::SPLIT_BK : tc_bwd::Tiling<DH>::BK;
  const size_t smem = SPLIT ? tc_bwd::SplitTiling<DH>::SMEM : tc_bwd::Tiling<DH>::SMEM;
  const auto kernel = bwd_tc_kernel<DH, DROP>();
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(opt_in, kernel, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T_len + BK - 1) / BK, a.H, a.B);
  kernel<<<grid, tc_bwd::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.bias, a.kv_end,
      a.lse, a.dsum, a.dq_acc, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.T_len,
      a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.drop);
  return cudaGetLastError();
}

// a wide head dim: one block per (key tile, column group), head, item
template <int NG>
cudaError_t launch_f32_wide(const Args& a) {
  using namespace f32_bwd;
  cudaError_t err = launch_prepass<float, 0>(a);
  if (err != cudaSuccess) return err;
  const size_t smem = wide_smem_floats<NG>() * sizeof(float);
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_bwd_f32_wide<NG>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T_len + BK - 1) / BK * (a.dh / NG), a.H, a.B);
  attention_bwd_f32_wide<NG><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.bias, a.kv_end,
      a.lse, a.dsum, a.dq_acc, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T_len,
      a.dh, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.drop);
  return cudaGetLastError();
}

template <int NG, bool DROP>
cudaError_t launch_tc_wide(const Args& a) {
  using Tile = tc_bwd::WideTiling<NG>;
  cudaError_t err = launch_prepass<bf16, 0>(a);
  if (err != cudaSuccess) return err;
  const size_t smem = Tile::SMEM;
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, attention_bwd_tc_wide<NG, DROP>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T_len + tc_bwd::SPLIT_BK - 1) / tc_bwd::SPLIT_BK * (a.dh / NG), a.H, a.B);
  attention_bwd_tc_wide<NG, DROP><<<grid, tc_bwd::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.bias, a.kv_end,
      a.lse, a.dsum, a.dq_acc, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.T_len,
      a.dh, a.qs, a.ks, a.vs, a.ds, a.sm_scale, a.drop);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// The column groups of dK, dV and dQ the kernel of `dtype` runs head dim
// dh in: 1 at a built dh, dh / group_width above 256; 0 for a dtype or dh
// the C entry refuses.
extern "C" int attention_bwd_column_groups(int dtype, int dh) {
  if (dtype != fs2::kFloat32 && dtype != fs2::kBFloat16) return 0;
  if (fs2::attn::built_dh(dh)) return 1;
  if (!fs2::attn::wide_dh(dh)) return 0;
  return dh / fs2::attn::group_width(dtype == fs2::kBFloat16, dh, true);
}

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
  if (B <= 0 || H <= 0 || T_len <= 0 || thresh < 0 || thresh > 0xffffffffLL ||
      (thresh > 0 && seed == nullptr) ||
      kv_end == nullptr || row_offset < 0 || head_offset < 0 || head_offset + H > heads_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, o, static_cast<const float*>(key_bias),
               static_cast<int*>(kv_end), static_cast<const float*>(lse),
               static_cast<float*>(dsum), static_cast<float*>(dq_acc), dk, dv, B, H,
               T_len, dh, Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
               Strides{v_sb, v_sh, v_st}, Strides{d_sb, d_sh, d_st},
               Strides{o_sb, o_sh, o_st}, sm_scale,
               Dropout{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale,
                       row_offset, head_offset, heads_total},
               static_cast<cudaStream_t>(stream)};
  const bool dropout = thresh > 0;
  if ((dtype != fs2::kFloat32 && dtype != fs2::kBFloat16) ||
      !(fs2::attn::built_dh(dh) || fs2::attn::wide_dh(dh)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = fs2::attn::launch_kv_end(a.bias, B, T_len, a.kv_end, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fs2::attn::wide_dh(dh)) {
    if (dtype == fs2::kFloat32) return launch_f32_wide<128>(a);
    switch (fs2::attn::group_width(true, dh, true)) {
      case 256: return dropout ? launch_tc_wide<256, true>(a) : launch_tc_wide<256, false>(a);
      case 192: return dropout ? launch_tc_wide<192, true>(a) : launch_tc_wide<192, false>(a);
      default: return dropout ? launch_tc_wide<128, true>(a) : launch_tc_wide<128, false>(a);
    }
  }
#define FS2_BWD_DH(DH)                                                        \
  if (dh == DH) {                                                             \
    if (dtype == fs2::kFloat32) return launch_f32<DH>(a);                     \
    return dropout ? launch_tc<DH, true>(a) : launch_tc<DH, false>(a);        \
  }
  FS2_BWD_DH(64)
  FS2_BWD_DH(128)
  FS2_BWD_DH(192)
  FS2_BWD_DH(256)
#undef FS2_BWD_DH
  return static_cast<int>(cudaErrorInvalidValue);
}
