// CTC forward-sum over blank-interleaved states s = 0..2L (label(s) = 0 for
// even s, (s + 1) / 2 for odd s): the alpha and beta scans, and the
// posterior gradient from their rows.
//
//   emit_t(s)  = t < out_len ? logprobs[t, label(s)] : (label(s) == 0 ? 0 : NEG_INF)
//   alpha_t(s) = max(lse3(alpha_{t-1}(s), alpha_{t-1}(s-1), [s odd] alpha_{t-1}(s-2))
//                    + emit_t(s), NEG_INF),   alpha_{-1} = (s == 0 ? 0 : NEG_INF)
//   beta_{T-1}(s) = 0 on s in {2 in_len - 1, 2 in_len}, else NEG_INF
//   beta_t(s)  = max(lse3(w(s), w(s+1), [s odd] w(s+2)), NEG_INF),
//                w = beta_{t+1} + emit_{t+1}
//   gamma_t(s) = exp(clip(alpha_t(s) + beta_t(s) - ll, -80, 0))
//   grad[t, 0] = -g * sum over even s of gamma_t(s); grad[t, c] = -g * gamma_t(2c - 1);
//   grad[t, :] = 0 for t >= out_len
// with NEG_INF = -1e15 and lse3 = NEG_INF wherever its max <= NEG_INF / 2.
//
// logprobs [B, T, L+1] f32 contiguous (column 0 blank); alphas, betas
// [B, T, S] f32; in_lens, out_lens [B] int32; ll, g [B] f32; grad [B, T, L+1].
//
// Replaces fastspeech2_lightning_tpu/ops/ctc_pallas.py:120
// banded_lse_scan_pallas (_make_kernel :34), run by ops/ctc.py:83-91 (alpha)
// and :173-188 (beta); the posterior gradient (ops/ctc.py:216-226) is the
// third entry, and the emission gather and padded-frame blank forcing
// (_uniform_logprobs, :42-48) happen where the rows are staged.
//
// Arithmetic: every value is the plain version's (ops/ctc.py) to the bit:
// accurate expf and logf, lse3 as the max plus the log of the three
// exponentials added in the same order, the same clamps (lse2 and lse3
// below say why one exponential fewer gives the same sums). At the top
// training bucket |alpha| and |beta| reach 1e4, where one ulp of
// alpha + beta - ll moves gamma by 0.1 %; only equal arithmetic keeps the
// gradient within 1e-5 of the plain version's.
//
// Bound. The alpha chain reads the live rows of logprobs and writes
// B*T*S*4 bytes; both chains read them once and write twice that; the
// gradient reads the live frames' alpha and beta rows and writes
// B*T*(L+1)*4. At B=16, T=1024, L=160 that is 9-15 us of bytes at
// 3.35 TB/s. What bounds the chains is not bytes but T dependent frames:
// a frame's new state needs the lane below's top state of the frame before
// (a shuffle), then an lse3 whose accurate expf and logf make a chain of
// about 40 dependent instructions. The gradient is a pass over bytes.
//
// Design of a chain (one block per item and chain: B blocks for alpha alone,
// 2B for alpha and beta side by side in one launch).
//  - beta runs as alpha does, on the reversed state index s' = 2L - s
//    (parity kept), carrying w = beta + emit: w_t(s') = max(lse3(w_{t+1}(s'),
//    w_{t+1}(s'-1), [s' odd] w_{t+1}(s'-2)), NEG_INF) + emit_t(s'). One code
//    path, the two chains differ only in when the emission is added and
//    where a row is stored.
//  - States in registers: a lane holds K consecutive states from an even
//    one, so a frame needs one shuffle (the top state of the lane below):
//    K = 2 up to S = 448 (every training bucket: at most 8 warps, two a
//    scheduler), K = 4 above (at most 19 warps at the ring's limit S = 2047).
//  - No barrier a frame: each warp's first four lanes carry the 4 K states
//    left of its 28 K (a halo, recomputed with the same arithmetic). A halo
//    state stays right two states less each frame, so the halo serves 2 K
//    frames; every 2 K frames the warps meet at one named barrier over the
//    item's warps and take the halo afresh from their neighbour's top lanes
//    through shared memory.
//  - Emissions off the chain: a copy warp stages the frames, a chunk of 2 K
//    at a time, into a 32-frame ring in shared memory by cp.async, 24 or 16
//    frames ahead, and hands each chunk over at the same barrier; a padded
//    frame (t >= out_len) is written as blank 0, labels NEG_INF instead. A
//    lane reads its emissions (the blank and K / 2 labels) from the ring;
//    the reads do not depend on the chain, so they issue ahead of it.
//  - Rows leave by stores the chain never waits on.
// A frame's loop holds about 115 SASS instructions a warp at K = 2 and 217
// at K = 4 (cuobjdump -sass, sm_90a). Measured on an NVIDIA H100 80GB HBM3
// at a 700 W limit (PERF.md):
// about 185 ns a frame with one warp a scheduler, 240 with two; four states
// a lane on one warp a scheduler took 280-300 (in-order issue waits on the
// chain inside a warp); a copy of logf without its branches for zero,
// subnormal and infinite arguments (bit-equal over [1, 3], the only sums an
// lse takes) moved nothing, so the chain's latency, not issue, sets the
// time.
// Texts past the ring's reach (S > 2047: 1024 symbols or more): a ring of
// 32 frames over the whole row would take
// 32 (L + 1) floats, more shared memory than a block has. There a chain is
// spread over a thread-block cluster (ctc_chain_cluster_kernel, below the
// ring kernel's run_chain): each block runs the ring kernel at K = 4 on a
// slice of the states, stages only its slice's emission columns, and takes
// its first warp's halo from the block on its left through distributed
// shared memory, a wait on an mbarrier of its own instead of a barrier of
// the cluster. slice_layout picks the blocks a chain (2 to 8) from the
// waves of clusters the card runs them in and the warps a block takes. Past
// PANEL_S (16383, 8191 symbols, the S that the JAX package's own Pallas gate
// admits at B 16) a chain's states are cut into panels launched in turn,
// each such a cluster, whose first block takes its halo from the rows the
// panel before it stored. The output rows are
// [B, T, S] f32 (512 MB each at B 16, T 2048, S 4001), as in JAX.
//
// Design of the gradient: one warp a (b, t) row over all SMs, the even-state
// sum by shuffles within the warp; a padded frame writes its zeros without
// reading alpha or beta.

#include <math.h>

#include "cluster.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e15f;
constexpr int PANEL_S = 16383;             // states a launch's clusters take (L <= 8191)
constexpr int RING_S = 2047;               // the ring chains' reach (L <= 1023)
constexpr int HALO_LANES = 4;              // lanes a warp spends on its halo
constexpr int RING_FRAMES = 32;            // frames the emission ring holds
constexpr int GRAD_ROWS = 8;               // (b, t) rows a gradient block
constexpr unsigned FULL = 0xffffffffu;

// K states a lane, from an even one: a warp owns 28 K states and carries
// the 4 K left of them; a halo state stays right two states less a frame,
// so the warps meet every 2 K frames (CHUNK)
template <int K>
struct Layout {
  static constexpr int OWN = (32 - HALO_LANES) * K;
  static constexpr int CHUNK = HALO_LANES * K / 2;
  static constexpr int SLOTS = RING_FRAMES / CHUNK;
};
constexpr int K_SHORT = 2, K_LONG = 4;  // two states a lane up to 8 warps (S <= 448), else four
constexpr int SHORT_S = 8 * Layout<K_SHORT>::OWN;
template <int K>
constexpr int max_warps() {
  return K == K_SHORT ? 8 : (RING_S + Layout<K>::OWN - 1) / Layout<K>::OWN;
}
constexpr int HALO_FLOATS = max_warps<K_LONG>() * HALO_LANES * K_LONG;  // floats a meet

// barrier `id` over n threads of the block (n a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The plain version's lse3(a, b, NEG_INF) and lse3(a, b, c): the max plus
// the log of (e^(a-m) + e^(b-m)) + e^(c-m). The max's own term is exp(0) = 1
// exactly and a sum of two terms does not depend on their order, so one
// exponential fewer gives the same bits: (1 + e^(min(a,b)-m)) + e^(c-m)
// when a or b is the max, (e^(a-m) + e^(b-m)) + 1 when c is.
__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float out = m + logf(1.f + expf(fminf(a, b) - m));
  return m > 0.5f * NEG_INF ? out : NEG_INF;
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float mab = fmaxf(a, b), m = fmaxf(mab, c);
  const bool c_max = c >= mab;
  const float p = expf((c_max ? a : fminf(a, b)) - m);
  const float q = expf((c_max ? b : c) - m);
  const float out = m + logf(c_max ? (p + q) + 1.f : (1.f + p) + q);
  return m > 0.5f * NEG_INF ? out : NEG_INF;
}

// One frame of a chain: this lane's K states x (alpha_{t-1}, or w_{t+1})
// become the frame's, given their emissions e; the owned ones are stored at
// o[k] (alpha) or o[-k] (beta). `init`: beta's first frame (T - 1).
template <int K, bool BETA>
__device__ __forceinline__ void chain_frame(float (&x)[K], const float (&e)[K], bool init,
                                            float* o, const bool (&keep)[K], int first, int S,
                                            int s_blank, int s_label) {
  // the top state of the lane below; lane 0 (a halo lane, whose leftmost
  // state is not right after a frame anyway) takes its own: in warp 0
  // every state left of 0 stays <= NEG_INF whatever it takes
  const float left = __shfl_up_sync(FULL, x[K - 1], 1);
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float p1 = k >= 1 ? x[k - 1] : left;
    v[k] = k & 1 ? lse3(x[k], p1, k >= 2 ? x[k - 2] : left) : lse2(x[k], p1);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (BETA) {
      if (init) {
        const int s = S - 1 - (first + k);
        v[k] = s == s_blank || s == s_label ? 0.f : NEG_INF;
      } else {
        v[k] = fmaxf(v[k], NEG_INF);
      }
      x[k] = v[k] + e[k];
    } else {
      v[k] = fmaxf(v[k] + e[k], NEG_INF);
      x[k] = v[k];
    }
    if (keep[k]) o[BETA ? -k : k] = v[k];
  }
}

// Meet m of a chain's warps, at barrier 1 over the block (the copy warps
// hand a ring chunk over at the same barrier): from the second meet on,
// this warp's top HALO_LANES lanes hand their states on through `meet`
// ([warp][HALO_LANES * K] floats), and its first HALO_LANES lanes take the
// warp below's as their halo; warp 0 takes `edge_in`'s (the block on the
// left's, in a cluster) unless it is null.
template <int K>
__device__ __forceinline__ void meet_halo(float (&x)[K], float* meet, const float* edge_in,
                                          int m, int warp, int lane) {
  constexpr int H = HALO_LANES * K;
  if (m > 0 && lane >= 32 - HALO_LANES) {
#pragma unroll
    for (int k = 0; k < K; ++k) meet[warp * H + (lane - (32 - HALO_LANES)) * K + k] = x[k];
  }
  bar_sync(1, blockDim.x);
  if (m > 0 && (warp > 0 || edge_in) && lane < HALO_LANES) {
    const float* from = warp > 0 ? meet + (warp - 1) * H : edge_in;
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = from[lane * K + k];
  }
}

// One chain of one item: chain warps 0 .. n_warps - 1, then the copy warp.
// BETA: the beta chain on reversed states, frames from T - 1 down.
template <int K, bool BETA>
__device__ __forceinline__ void run_chain(const float* __restrict__ lp, float* __restrict__ out,
                                          float* ring, float* halo, int T, int L, int in_len,
                                          int out_len) {
  using Lay = Layout<K>;
  constexpr int CHUNK = Lay::CHUNK, SLOTS = Lay::SLOTS, OWN = Lay::OWN;
  const int S = 2 * L + 1, Lp1 = L + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x >> 5) - 1;
  const int n_chunks = (T + CHUNK - 1) / CHUNK;

  if (warp == n_warps) {  // the copy warp: chunk m (steps CHUNK m ..) into ring slot m % SLOTS
    auto copy_chunk = [&](int m) {
      if (m < n_chunks) {
        float* dst = ring + (m % SLOTS) * CHUNK * Lp1;
        for (int j = m * CHUNK; j < min(T, (m + 1) * CHUNK); ++j, dst += Lp1) {
          const int t = BETA ? T - 1 - j : j;
          if (t < out_len) {
            const float* src = lp + static_cast<long long>(t) * Lp1;
            for (int c = lane; c < Lp1; c += 32) fs2::tc::cp_async4(dst + c, src + c, true);
          } else {
            for (int c = lane; c < Lp1; c += 32) dst[c] = c == 0 ? 0.f : NEG_INF;
          }
        }
      }
      fs2::tc::cp_async_commit();
    };
    for (int m = 0; m < SLOTS - 1; ++m) copy_chunk(m);
    for (int m = 0; m < n_chunks; ++m) {
      // chunk m + SLOTS - 2 goes where chunk m - 2 was: the chain warps
      // left it before the barrier that handed them chunk m - 1
      if (m > 0) copy_chunk(m + SLOTS - 2);
      fs2::tc::cp_async_wait<SLOTS - 2>();  // chunk m has landed
      bar_sync(1, blockDim.x);               // and is handed over
    }
    return;
  }

  // this lane's states first .. first + K - 1, in the chain's order (s' for beta)
  const int first = warp * OWN - HALO_LANES * K + lane * K;
  // emission columns of the odd states first + 1 + 2 j; lanes outside
  // [0, S) read any finite column (their values stay <= NEG_INF left of
  // state 0 and do not reach the states right of them)
  int col[K / 2];
#pragma unroll
  for (int j = 0; j < K / 2; ++j)
    col[j] = min(max(BETA ? L - first / 2 - j : first / 2 + 1 + j, 0), L);
  bool keep[K];  // owned and in range: this lane stores state first + k
#pragma unroll
  for (int k = 0; k < K; ++k) keep[k] = lane >= HALO_LANES && first + k >= 0 && first + k < S;
  // where state first + k of step j goes: o[k] (alpha), o[-k] (beta)
  float* o = out + (BETA ? static_cast<long long>(T - 1) * S + (S - 1 - first) : first);
  const long long row_step = BETA ? -S : S;
  const int s_blank = min(max(2 * in_len, 0), S - 1);
  const int s_label = min(max(2 * in_len - 1, 0), S - 1);

  float x[K];  // alpha_{t-1}, or w_{t+1} = beta_{t+1} + emit_{t+1}
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = !BETA && first + k == 0 ? 0.f : NEG_INF;

  auto step = [&](const float* row, bool init) {
    float e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = k & 1 ? row[col[k / 2]] : row[0];
    chain_frame<K, BETA>(x, e, init, o, keep, first, S, s_blank, s_label);
    o += row_step;
  };

  // the halo floats of warp w at meet m: halo[m & 1][w][HALO_LANES * K]
  for (int m = 0; m < n_chunks; ++m) {
    meet_halo<K>(x, halo + (m & 1) * HALO_FLOATS, nullptr, m, warp, lane);
    const float* rows = ring + (m % SLOTS) * CHUNK * Lp1;
    const int n = min(CHUNK, T - m * CHUNK);
    if (m > 0 && n == CHUNK) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) step(rows + i * Lp1, false);
    } else {
#pragma unroll 1
      for (int i = 0; i < n; ++i) step(rows + i * Lp1, m == 0 && i == 0);
    }
  }
}

// -- texts past the ring's reach: a cluster of blocks a chain -----------------
//
// Past S = 2047 a ring of 32 frames over the whole row of emissions would
// not fit one block's shared memory, and one block's issue rate would set
// the pace of a chain of more states. So a chain's states (in its own
// order: s' for beta) are cut into contiguous slices, one block of a
// thread-block cluster each (slice_layout picks how many). Each block is
// the ring kernel at K = 4 on its slice: n_warps chain warps of 28 K
// owned states, the first carrying the 4 K states left of the slice as its
// halo, and four copy warps (one a scheduler) staging only the emission
// columns of the block's states (the blank, then a window of n_warps 14 K
// + 2 K labels) into its own 32-frame ring, 16-24 frames ahead, handed over
// at the named barrier where the warps meet every 2 K frames. A courier
// warp carries the halo across the block boundary: after a meet it stores
// the last chain warp's top states into the next block's shared memory
// (st.shared::cluster) and arrives on an mbarrier there; before a meet it
// waits on its own block's mbarrier and puts what arrived where warp 0
// takes it after the meet, as every other warp takes its neighbour's.
// Nothing flows leftwards, so a block runs ahead of the one on its right by
// up to EDGE_SLOTS hand-overs, no meet waits on the whole cluster, and no
// chain warp waits on the cluster at all. The arithmetic and its order are
// run_chain's (chain_frame is the one frame update both call), so the rows
// are the plain version's to the bit.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md; tools/default_shapes_ab.py
// in turns with the direct chains this replaced, in parentheses): at
// (16, 2048, 2000), S 4001, ctc_alpha 0.885 ms (3.227; 16 chains in
// clusters of 6 blocks of 6 warps) and ctc_alpha_beta 1.107 (3.376; 32
// chains, 3 blocks of 12 warps); at S 8193 1.275 (23.85) and 2.379 (24.77);
// at S 16383 2.300 (39.79, one wave of 6 blocks of 25 warps) and 4.599
// (43.80, two waves). A frame takes longer the more chain warps a block
// has (at S 4001, 6 warps 429 ns, 9 511, 12 535, 18 813;
// tools/cluster_chain_variants.py): the chain is bound by its SM's issue
// and the lse's latency, so narrower slices on more SMs are faster, up to
// the waves the cluster sizes force (the card holds 15 clusters of 8, 17
// of 6, 30 of 4, 39 of 3; slice_layout). The same card read other times for
// the same build on other calls (PERF.md): compare only within a call.
// Alternatives set aside (tools/cluster_chain_variants.py, one call,
// ctc_alpha and ctc_alpha_beta ms at S 4001 unless said):
//  - the direct chains (K = 8 or 32 states a lane, emissions read from
//    device memory a frame ahead, 32 spilling 450 bytes a thread);
//  - a barrier of the cluster at every meet: a hand-over runs one way, so
//    an mbarrier in the receiving block does;
//  - the hand-over carried by a chain warp or a copy warp: a release at
//    cluster scope waits for the thread's memory operations, a copy warp's
//    cp.async in flight among them, so it has a warp of its own;
//  - one copy warp (1.121, 2.367) or two (0.840, 1.392) against four
//    (0.878, 1.102);
//  - other layouts: 2 x 18 warps 1.666 and 1.779, 3 x 12 1.095 and 1.100,
//    4 x 9 1.046 and 1.962 (two waves), 6 x 6 0.878 and 1.651 (two waves),
//    8 x 5 1.719 and 2.378; a second block an SM allowed (no SM_ALONE; 8 x
//    5 then): 1.152 and 1.795; at S 16383, 8 blocks of 19 warps (two and
//    three waves) 3.063 and 4.742 against 2.290 and 4.641;
//  - at most 19 chain warps a block (768 threads): 0.940 and 1.183, the
//    chain kept to 40 registers; at S 16383 3.293 and 4.724;
//  - a wider halo at the block boundary than between warps: the hand-over
//    rides the warps' own meet every 2 K frames and costs the chain nothing.
//
// Past PANEL_S states a chain would need more blocks than a portable
// cluster holds, so its states are cut into panels of equal layout, each
// covering `blocks x warps x 112` states of the chain's order from s_base,
// launched in turn on one stream (alpha and beta side by side, panel for
// panel). A panel's first block takes its halo at each meet from the rows
// the panel before it stored, instead of from a courier: the halo states
// are that panel's owned states, its launch has ended, and what a courier
// would have handed on is the row of the frame before the meet, read from
// device memory (for beta, w = beta + the frame's emission, added as the
// chain adds it). So the rows are still the plain version's to the bit.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 33): at (4,
// 16384, 12000), S 24001 in two panels of 8 blocks of 14 warps, ctc_alpha
// 19.77 ms and ctc_alpha_beta 20.09 (its 8 chains still one wave), about
// 600 ns a frame and panel.
constexpr int K_SLICE = K_LONG;
using SliceLayout = Layout<K_SLICE>;
constexpr int EDGE = HALO_LANES * K_SLICE;          // halo states a block takes from its left
constexpr int EDGE_SLOTS = 4;                       // hand-overs in flight between two blocks
// The choices below are macros so that tools/cluster_chain_variants.py can
// build the source with others (-D) and time them against these defaults.
#ifndef FS2T_CTC_COPY_WARPS
#define FS2T_CTC_COPY_WARPS 4
#endif
#ifndef FS2T_CTC_SLICE_WARPS
#define FS2T_CTC_SLICE_WARPS 0
#endif
#ifndef FS2T_CTC_BLOCKS
#define FS2T_CTC_BLOCKS 0
#endif
#ifndef FS2T_CTC_SM_ALONE_KB
#define FS2T_CTC_SM_ALONE_KB 120
#endif
constexpr int SLICE_COPY_WARPS = FS2T_CTC_COPY_WARPS;  // one a scheduler: the copies spread evenly
// chain warps a block at most: with the copy warps and the courier, 1024
// threads (3024 states, so S 16383 fits 6 blocks: one wave of 16 chains)
constexpr int SLICE_WARPS =
    FS2T_CTC_SLICE_WARPS > 0 ? FS2T_CTC_SLICE_WARPS : 32 - SLICE_COPY_WARPS - 1;
constexpr int MAX_CLUSTER = 8;                      // blocks a chain at most (portable clusters)
// blocks a chain where slice_layout does not pick (0: it picks)
constexpr int FORCED_CLUSTER = FS2T_CTC_BLOCKS;
// dynamic shared memory of at least this keeps a second block off the SM:
// a slice's chain is bound by the issue and latency of the SM it runs on
constexpr size_t SM_ALONE = FS2T_CTC_SM_ALONE_KB * size_t{1024};

// floats of a ring frame: the blank, then the window of label columns
__host__ __device__ constexpr int slice_row(int warps) {
  return 1 + warps * SliceLayout::OWN / 2 + EDGE / 2;
}

inline size_t slice_smem(int warps) {
  const size_t ring = sizeof(float) * RING_FRAMES * slice_row(warps);
  return ring > SM_ALONE ? ring : SM_ALONE;
}

// One block's slice of one chain: chain warps 0 .. n_warps - 1 over states
// rank W .. rank W + W - 1 (W = 28 K n_warps, in the chain's order), then
// the copy warp.
template <bool BETA>
__device__ __forceinline__ void run_chain_slice(const float* __restrict__ lp,
                                                float* __restrict__ out, float* ring,
                                                float* meet, float (*edge)[EDGE],
                                                float (*edge_in)[EDGE], uint64_t* full,
                                                uint64_t* empty, int T, int L, int in_len,
                                                int out_len, int rank, int size, int s_base) {
  constexpr int K = K_SLICE, CHUNK = SliceLayout::CHUNK, SLOTS = SliceLayout::SLOTS;
  constexpr int OWN = SliceLayout::OWN;
  const int S = 2 * L + 1, Lp1 = L + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x >> 5) - SLICE_COPY_WARPS - 1;  // then the copy warps, the courier
  const int n_chunks = (T + CHUNK - 1) / CHUNK;
  const int W = n_warps * OWN, s0 = s_base + rank * W;
  const int rf = slice_row(n_warps);
  // the window's first label column: the odd states of this block's lanes
  // (halo included) read columns cw0 .. cw0 + rf - 2; ring slot 0 is the blank
  const int cw0 = BETA ? L - (s0 + W) / 2 + 1 : s0 / 2 - EDGE / 2 + 1;

  if (warp == n_warps + SLICE_COPY_WARPS) {
    // the courier: the halo across the block boundaries, hand-over m - 1 at
    // meet m (lanes 0 .. EDGE - 1): from the left block's `edge` slot into
    // edge_in before the meet, and from the last chain warp's top states in
    // `meet` into the right block's slot after it, so the chain warps never
    // wait on the cluster. A warp of its own: a release waits for its
    // thread's memory operations, which for a copy warp would be cp.async
    // copies still in flight. A panel's first block (past the chain's first
    // state) takes the hand-over from the row the panel before it stored
    // for the frame before the meet instead: state s0 - EDGE + lane, in the
    // chain's order
    const bool carries = lane < EDGE;
    const int sh = s0 - EDGE + lane;            // the halo state this lane carries
    const int s_real = BETA ? S - 1 - sh : sh;  // its index in the rows
    const int col = s_real & 1 ? (s_real + 1) >> 1 : 0;  // its emission column
    for (int m = 0; m < n_chunks; ++m) {
      const int slot = (m - 1) % EDGE_SLOTS;
      const uint32_t parity = ((m - 1) / EDGE_SLOTS) & 1;
      if (carries && m > 0 && rank > 0) {
        fs2::cluster::wait(&full[slot], parity);
        edge_in[m & 1][lane] = edge[slot][lane];
        fs2::cluster::arrive(fs2::cluster::map(&empty[slot], rank - 1));
      } else if (carries && m > 0 && s0 > 0) {
        const int j = m * CHUNK - 1;  // the frame before the meet, in the chain's order
        const int t = BETA ? T - 1 - j : j;
        float v = out[static_cast<long long>(t) * S + s_real];
        if (BETA)  // w = beta + emit, as chain_frame adds it
          v += t < out_len ? lp[static_cast<long long>(t) * Lp1 + col] : (col ? NEG_INF : 0.f);
        edge_in[m & 1][lane] = v;
      }
      __syncwarp();
      bar_sync(1, blockDim.x);
      if (carries && m > 0 && rank + 1 < size) {
        const float v = meet[(m & 1) * SLICE_WARPS * EDGE + (n_warps - 1) * EDGE + lane];
        fs2::cluster::wait(&empty[slot], parity ^ 1);  // the right block took the slot's last
        fs2::cluster::store(fs2::cluster::map(&edge[slot][lane], rank + 1), v);
        fs2::cluster::arrive(fs2::cluster::map(&full[slot], rank + 1));
      }
      __syncwarp();
    }
    return;
  }
  if (warp >= n_warps) {  // copy warps: chunk m (steps CHUNK m ..) into ring slot m % SLOTS
    const int c0 = (warp - n_warps) * 32 + lane;  // of the copy lanes
    auto copy_chunk = [&](int m) {
      if (m < n_chunks) {
        float* dst = ring + (m % SLOTS) * CHUNK * rf;
        for (int j = m * CHUNK; j < min(T, (m + 1) * CHUNK); ++j, dst += rf) {
          const int t = BETA ? T - 1 - j : j;
          if (t < out_len) {
            const float* src = lp + static_cast<long long>(t) * Lp1;
            for (int i = c0; i < rf; i += 32 * SLICE_COPY_WARPS) {
              const int c = i == 0 ? 0 : cw0 + i - 1;
              fs2::tc::cp_async4(dst + i, c >= 0 && c <= L ? src + c : lp, c >= 0 && c <= L);
            }
          } else {
            for (int i = c0; i < rf; i += 32 * SLICE_COPY_WARPS) dst[i] = i == 0 ? 0.f : NEG_INF;
          }
        }
      }
      fs2::tc::cp_async_commit();
    };
    for (int m = 0; m < SLOTS - 1; ++m) copy_chunk(m);
    for (int m = 0; m < n_chunks; ++m) {
      if (m > 0) copy_chunk(m + SLOTS - 2);
      fs2::tc::cp_async_wait<SLOTS - 2>();  // chunk m has landed
      bar_sync(1, blockDim.x);               // and is handed over
    }
    return;
  }

  // as in run_chain: this lane's states, where its odd states' columns lie
  // in the ring (a column clamped to 0 reads the blank), which it stores
  const int first = s0 + warp * OWN - EDGE + lane * K;
  int off[K / 2];
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    const int c = min(max(BETA ? L - first / 2 - j : first / 2 + 1 + j, 0), L);
    off[j] = c == 0 ? 0 : 1 + c - cw0;
  }
  bool keep[K];
#pragma unroll
  for (int k = 0; k < K; ++k) keep[k] = lane >= HALO_LANES && first + k >= 0 && first + k < S;
  float* o = out + (BETA ? static_cast<long long>(T - 1) * S + (S - 1 - first) : first);
  const long long row_step = BETA ? -S : S;
  const int s_blank = min(max(2 * in_len, 0), S - 1);
  const int s_label = min(max(2 * in_len - 1, 0), S - 1);

  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = !BETA && first + k == 0 ? 0.f : NEG_INF;

  auto step = [&](const float* row, bool init) {
    float e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = k & 1 ? row[off[k / 2]] : row[0];
    chain_frame<K, BETA>(x, e, init, o, keep, first, S, s_blank, s_label);
    o += row_step;
  };

  for (int m = 0; m < n_chunks; ++m) {
    meet_halo<K>(x, meet + (m & 1) * SLICE_WARPS * EDGE, s0 > 0 ? edge_in[m & 1] : nullptr,
                 m, warp, lane);
    const float* rows = ring + (m % SLOTS) * CHUNK * rf;
    const int n = min(CHUNK, T - m * CHUNK);
    if (m > 0 && n == CHUNK) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) step(rows + i * rf, false);
    } else {
#pragma unroll 1
      for (int i = 0; i < n; ++i) step(rows + i * rf, m == 0 && i == 0);
    }
  }
}

// clusters 0 .. B-1: alpha of item b; B .. 2B-1 (when betas is given):
// beta of item b - B; block `rank` of a cluster runs the slice from state
// s_base + rank x (its states), in the chain's order
__global__ void __launch_bounds__((SLICE_WARPS + SLICE_COPY_WARPS + 1) * 32)
ctc_chain_cluster_kernel(const float* __restrict__ logprobs, const int* __restrict__ in_lens,
                         const int* __restrict__ out_lens, float* alphas, float* betas, int B,
                         int T, int L, int s_base) {
  extern __shared__ float ring[];  // [RING_FRAMES][slice_row(n_warps)]
  __shared__ float meet[2 * SLICE_WARPS * EDGE];
  __shared__ float edge[EDGE_SLOTS][EDGE];  // the left block's top states, handed over
  __shared__ float edge_in[2][EDGE];        // the same, for warp 0, by chunk parity
  __shared__ uint64_t full[EDGE_SLOTS], empty[EDGE_SLOTS];
  const int rank = fs2::cluster::rank(), size = fs2::cluster::size();
  const int chain = blockIdx.x / size;
  const bool beta = chain >= B;
  const int b = beta ? chain - B : chain;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EDGE_SLOTS; ++s) {
      fs2::tc::mbar_init(&full[s], EDGE);
      fs2::tc::mbar_init(&empty[s], EDGE);
    }
    fs2::tc::mbar_init_fence();
  }
  fs2::cluster::sync();  // every block's mbarriers are set before any arrives on them
  const long long S = 2 * L + 1;
  const float* lp = logprobs + static_cast<long long>(b) * T * (L + 1);
  if (beta)
    run_chain_slice<true>(lp, betas + b * T * S, ring, meet, edge, edge_in, full, empty, T, L,
                          in_lens[b], out_lens[b], rank, size, s_base);
  else
    run_chain_slice<false>(lp, alphas + b * T * S, ring, meet, edge, edge_in, full, empty, T, L,
                           0, out_lens[b], rank, size, s_base);
  fs2::cluster::sync();  // no block leaves while a neighbour may still touch its shared memory
}

// blocks 0 .. B-1: alpha of item b; blocks B .. 2B-1 (when betas is given):
// beta of item b - B
template <int K>
__global__ void __launch_bounds__((max_warps<K>() + 1) * 32)
ctc_chain_kernel(const float* __restrict__ logprobs, const int* __restrict__ in_lens,
                 const int* __restrict__ out_lens, float* __restrict__ alphas,
                 float* __restrict__ betas, int B, int T, int L) {
  extern __shared__ float ring[];  // [RING_FRAMES][L + 1]
  __shared__ float halo[2 * HALO_FLOATS];
  const bool beta = blockIdx.x >= B;
  const int b = beta ? blockIdx.x - B : blockIdx.x;
  const long long S = 2 * L + 1;
  const float* lp = logprobs + static_cast<long long>(b) * T * (L + 1);
  if (beta)
    run_chain<K, true>(lp, betas + b * T * S, ring, halo, T, L, in_lens[b], out_lens[b]);
  else
    run_chain<K, false>(lp, alphas + b * T * S, ring, halo, T, L, 0, out_lens[b]);
}

__global__ void __launch_bounds__(GRAD_ROWS * 32)
ctc_grad_kernel(const float* __restrict__ alphas, const float* __restrict__ betas,
                const int* __restrict__ out_lens, const float* __restrict__ ll,
                const float* __restrict__ g, float* __restrict__ grad, int B, int T, int L) {
  const int row = blockIdx.x * GRAD_ROWS + (threadIdx.x >> 5);  // b * T + t
  const int lane = threadIdx.x & 31;
  if (row >= B * T) return;
  const int b = row / T, t = row - b * T;
  const int S = 2 * L + 1;
  float* gr = grad + static_cast<long long>(row) * (L + 1);
  if (t >= out_lens[b]) {  // padded frames get no gradient
    for (int c = lane; c <= L; c += 32) gr[c] = 0.f;
    return;
  }
  const float llb = ll[b], gb = g[b];
  const float* al = alphas + static_cast<long long>(row) * S;
  const float* be = betas + static_cast<long long>(row) * S;
  float even = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float gamma = expf(fminf(fmaxf(al[s] + be[s] - llb, -80.f), 0.f));
    if (s & 1)
      gr[(s + 1) >> 1] = -gamma * gb;
    else
      even += gamma;
  }
  for (int off = 16; off > 0; off >>= 1) even += __shfl_xor_sync(FULL, even, off);
  if (lane == 0) gr[0] = -even * gb;
}

template <int K>
cudaError_t launch(const float* logprobs, const int* in_lens, const int* out_lens,
                   float* alphas, float* betas, int B, int T, int L, cudaStream_t stream) {
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, ctc_chain_kernel<K>,
      static_cast<int>(sizeof(float) * RING_FRAMES * ((RING_S + 1) / 2)));
  if (attr != cudaSuccess) return attr;
  const int S = 2 * L + 1;
  const int threads = ((S + Layout<K>::OWN - 1) / Layout<K>::OWN + 1) * 32;
  const size_t smem = sizeof(float) * RING_FRAMES * (L + 1);
  ctc_chain_kernel<K><<<betas ? 2 * B : B, threads, smem, stream>>>(
      logprobs, in_lens, out_lens, alphas, betas, B, T, L);
  return cudaGetLastError();
}

fs2::SmemOptIn slice_opt_in;  // the launch's and the layout query's, per device
fs2::cluster::Occupancy slice_occupancy;

// The layout of `chains` chains of S states past the ring's reach. A
// frame on a block of w chain warps takes a floor and about 20-35 ns more
// a warp (the timings above), and the card holds `active` clusters of a
// layout at once, so the chains take ceil(chains / active) waves of that
// each: slice_layout picks the cluster size c, from the fewest blocks that
// hold S to MAX_CLUSTER, with the least waves x (w + 7), a block taking
// w = ceil(ceil(S / c) / 112) warps; on a tie, fewer waves.
cudaError_t slice_layout(int chains, int S, int* size, int* warps, int* active) {
  const cudaError_t attr = fs2::smem_opt_in(slice_opt_in, ctc_chain_cluster_kernel,
                                            static_cast<int>(slice_smem(SLICE_WARPS)));
  if (attr != cudaSuccess) return attr;
  constexpr int OWN = SliceLayout::OWN;
  const int fewest = (S + SLICE_WARPS * OWN - 1) / (SLICE_WARPS * OWN);
  if (fewest > MAX_CLUSTER) return cudaErrorInvalidValue;
  long best = -1, best_waves = 0;
  const int first = FORCED_CLUSTER > fewest ? FORCED_CLUSTER : fewest;
  const int last = FORCED_CLUSTER > 0 ? FORCED_CLUSTER : MAX_CLUSTER;
  for (int c = first; c <= last; ++c) {
    const int w = ((S + c - 1) / c + OWN - 1) / OWN;
    const int sz = (S + w * OWN - 1) / (w * OWN);
    int n = 0;
    const cudaError_t err = fs2::cluster::max_active(slice_occupancy, ctc_chain_cluster_kernel,
                                                     sz, (w + SLICE_COPY_WARPS + 1) * 32,
                                                     slice_smem(w), &n);
    if (err != cudaSuccess) return err;
    if (n < 1) continue;
    const long waves = (chains + n - 1) / n, cost = waves * (w + 7);
    if (best < 0 || cost < best || (cost == best && waves < best_waves)) {
      best = cost, best_waves = waves;
      *size = sz, *warps = w, *active = n;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The layout of `chains` chains of S states in panels: the panels of
// equal layout, each at most PANEL_S states, and slice_layout's choice for
// one of them (`states` of the chain's order each).
cudaError_t panel_layout(int chains, int S, int* size, int* warps, int* active, int* panels) {
  const int first = (S + PANEL_S - 1) / PANEL_S;
  const cudaError_t err = slice_layout(chains, (S + first - 1) / first, size, warps, active);
  if (err != cudaSuccess) return err;
  const int states = *size * *warps * SliceLayout::OWN;
  *panels = (S + states - 1) / states;
  return cudaSuccess;
}

cudaError_t launch_slices(const float* logprobs, const int* in_lens, const int* out_lens,
                          float* alphas, float* betas, int B, int T, int L, cudaStream_t stream) {
  const int chains = betas ? 2 * B : B;
  int size = 0, warps = 0, active = 0, panels = 0;
  cudaError_t err = panel_layout(chains, 2 * L + 1, &size, &warps, &active, &panels);
  if (err != cudaSuccess) return err;
  const int W = warps * SliceLayout::OWN, S = 2 * L + 1;
  for (int p = 0; p < panels; ++p) {
    // the last panel takes only the blocks that start below S
    const int s_base = p * size * W, blocks = min(size, (S - s_base + W - 1) / W);
    err = fs2::cluster::launch(slice_occupancy, ctc_chain_cluster_kernel, chains * blocks, blocks,
                               (warps + SLICE_COPY_WARPS + 1) * 32, slice_smem(warps), stream,
                               logprobs, in_lens, out_lens, alphas, betas, B, T, L, s_base);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// two states a lane up to 8 warps (every training bucket), four up to the
// ring's reach, then a cluster of blocks a chain
cudaError_t launch_chains(const void* logprobs, const void* in_lens, const void* out_lens,
                          void* alphas, void* betas, int B, int T, int L, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || L <= 0) return cudaErrorInvalidValue;
  const auto lp = static_cast<const float*>(logprobs);
  const auto il = static_cast<const int*>(in_lens), ol = static_cast<const int*>(out_lens);
  const auto al = static_cast<float*>(alphas), be = static_cast<float*>(betas);
  const int S = 2 * L + 1;
  if (S <= SHORT_S) return launch<K_SHORT>(lp, il, ol, al, be, B, T, L, stream);
  if (S <= RING_S) return launch<K_LONG>(lp, il, ol, al, be, B, T, L, stream);
  return launch_slices(lp, il, ol, al, be, B, T, L, stream);
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// The slice layout the cluster kernel was built for, as ops/ctc.py names it
// (WARP_STATES, HALO_STATES, MEET_FRAMES, PANEL_S): a launch given another
// refuses.
static bool layout_is(int warp_states, int halo, int meet, int panel) {
  return warp_states == SliceLayout::OWN && halo == EDGE && meet == SliceLayout::CHUNK &&
         panel == PANEL_S;
}

// The alpha chain alone (a forward that needs no gradient). Returns a
// cudaError_t code (0 on success).
extern "C" int ctc_alpha(const void* logprobs, const void* out_lens, void* alphas, int B, int T,
                         int L, int warp_states, int halo, int meet, int panel, void* stream) {
  if (!layout_is(warp_states, halo, meet, panel)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chains(logprobs, nullptr, out_lens, alphas, nullptr, B, T, L,
                                        static_cast<cudaStream_t>(stream)));
}

// The alpha and beta chains side by side, one launch.
extern "C" int ctc_alpha_beta(const void* logprobs, const void* in_lens, const void* out_lens,
                              void* alphas, void* betas, int B, int T, int L, int warp_states,
                              int halo, int meet, int panel, void* stream) {
  if (!betas || !layout_is(warp_states, halo, meet, panel))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chains(logprobs, in_lens, out_lens, alphas, betas, B, T, L,
                                        static_cast<cudaStream_t>(stream)));
}

// The layout of a launch of `chains` chains (B for ctc_alpha, 2B for
// ctc_alpha_beta) at L labels: out[0] blocks a chain's cluster (1: the
// ring kernel), out[1] states a block owns, out[2] its chain warps, out[3]
// halo states a warp (and a block) takes from its left, out[4] frames
// between two meets, out[5] the clusters of out[0] blocks the card holds
// at once (0 for the ring kernel), out[6] the panels launched in turn.
extern "C" int ctc_cluster_layout(int chains, int L, int* out) {
  const int S = 2 * L + 1;
  if (chains <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= RING_S) {
    const int K = S <= SHORT_S ? K_SHORT : K_LONG, own = (32 - HALO_LANES) * K;
    const int warps = (S + own - 1) / own;
    out[0] = 1, out[1] = warps * own, out[2] = warps, out[3] = HALO_LANES * K, out[4] = K * 2;
    out[5] = 0, out[6] = 1;
    return 0;
  }
  const cudaError_t err = panel_layout(chains, S, &out[0], &out[2], &out[5], &out[6]);
  out[1] = out[2] * SliceLayout::OWN, out[3] = EDGE, out[4] = SliceLayout::CHUNK;
  return static_cast<int>(err);
}

// The limits the layouts keep to, as ops/ctc.py names them: out[0] RING_S
// (one block a chain up to here), out[1] MAX_CLUSTER (blocks a cluster at
// most), out[2] SLICE_WARPS (chain warps a block at most), out[3] PANEL_S
// (states a panel at most).
extern "C" int ctc_cluster_limits(int* out) {
  out[0] = RING_S, out[1] = MAX_CLUSTER, out[2] = SLICE_WARPS, out[3] = PANEL_S;
  return 0;
}

// The posterior gradient d(g . -ll)/d logprobs from the alpha and beta rows.
extern "C" int ctc_grad(const void* alphas, const void* betas, const void* out_lens,
                        const void* ll, const void* g, void* grad, int B, int T, int L,
                        void* stream) {
  if (B <= 0 || T <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B * T + GRAD_ROWS - 1) / GRAD_ROWS;
  ctc_grad_kernel<<<blocks, GRAD_ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alphas), static_cast<const float*>(betas),
      static_cast<const int*>(out_lens), static_cast<const float*>(ll),
      static_cast<const float*>(g), static_cast<float*>(grad), B, T, L);
  return static_cast<int>(cudaGetLastError());
}
