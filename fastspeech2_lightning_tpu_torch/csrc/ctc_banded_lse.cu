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
// Past S = 2047 (texts of 1024 symbols or more, up to S = 16383, 8191
// symbols, the S that the JAX package's own Pallas gate admits at B 16): a
// ring of 32 frames would take 32 (L + 1) floats, more shared memory than a
// block has. There the chains run without ring and copy warp
// (ctc_chain_direct_kernel, run_chain_direct): each lane reads its own
// emissions from device memory one frame ahead, into registers. States
// stay in registers with the same halo, and the arithmetic and its order
// are run_chain's (chain_frame is the one frame update both call), so the
// rows are the plain version's to the bit as before. K = 8 states a lane
// up to 24 warps (S <= 5376); K = 32 beyond, at most 19 warps at
// S = 16383, where the 32 states, their emissions and the lse temporaries
// spill about 450 bytes a thread (nvcc 12.9). Alternatives set aside: a
// thread-block cluster of several blocks an item, the halo through
// distributed shared memory, would spread a chain over SMs but puts a
// cluster barrier on every meet; more warps a block cannot hold more
// states (32 warps x 28 lanes x 16 states is 14336 < 16383 at the 64
// registers a thread such a block allows). The output rows are
// [B, T, S] f32 (512 MB each at B 16, T 2048, S 4001), as in JAX.
//
// Design of the gradient: one warp a (b, t) row over all SMs, the even-state
// sum by shuffles within the warp; a padded frame writes its zeros without
// reading alpha or beta.

#include <math.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e15f;
constexpr int MAX_S = 16383;               // states an item (L <= 8191)
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

// Meet m of a chain's warps, at barrier 1 over the block (the copy warp
// hands a ring chunk over at the same barrier): from the second meet on,
// this warp's top HALO_LANES lanes hand their states on through `meet`
// ([warp][HALO_LANES * K] floats), and its first HALO_LANES lanes take the
// warp below's as their halo.
template <int K>
__device__ __forceinline__ void meet_halo(float (&x)[K], float* meet, int m, int warp,
                                          int lane) {
  constexpr int H = HALO_LANES * K;
  if (m > 0 && lane >= 32 - HALO_LANES) {
#pragma unroll
    for (int k = 0; k < K; ++k) meet[warp * H + (lane - (32 - HALO_LANES)) * K + k] = x[k];
  }
  bar_sync(1, blockDim.x);
  if (m > 0 && warp > 0 && lane < HALO_LANES) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = meet[(warp - 1) * H + lane * K + k];
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
    meet_halo<K>(x, halo + (m & 1) * HALO_FLOATS, m, warp, lane);
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

// Past the ring's reach (S > 2047) a row of emissions is up to 32 KB, and
// a ring of a few chunks would not fit shared memory: no copy warp and no
// ring. Each lane reads its own emissions (the blank and K / 2 labels) from
// device memory one frame ahead of the chain, into registers; the reads do
// not depend on the chain, and a frame at K = 8 or 32 holds enough lse's to
// cover their latency. The warps meet every 2 K frames for the halo only.
// K = 8 up to 24 warps (S <= 5376), K = 32 beyond (at most 19 warps at
// S = 16383); the states, the halo and the arithmetic are run_chain's.
constexpr int K_WIDE = 8, K_HUGE = 32;
template <int K>
constexpr int direct_warps() {
  return K == K_WIDE ? 24 : (MAX_S + Layout<K>::OWN - 1) / Layout<K>::OWN;
}
constexpr int WIDE_S = direct_warps<K_WIDE>() * Layout<K_WIDE>::OWN;

template <int K, bool BETA>
__device__ __forceinline__ void run_chain_direct(const float* __restrict__ lp,
                                                 float* __restrict__ out, float* halo, int T,
                                                 int L, int in_len, int out_len) {
  using Lay = Layout<K>;
  constexpr int CHUNK = Lay::CHUNK, OWN = Lay::OWN;
  const int S = 2 * L + 1, Lp1 = L + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int n_chunks = (T + CHUNK - 1) / CHUNK;

  // as in run_chain: this lane's states, the columns of its odd states (any
  // finite column outside [0, S)), which it stores, and where
  const int first = warp * OWN - HALO_LANES * K + lane * K;
  const int col0 = BETA ? L - first / 2 : first / 2 + 1;  // column of state first + 1
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

  // the emissions of step j (frame T - 1 - j for beta): the blank and the
  // labels; a padded frame (t >= out_len) emits blank 0 and labels NEG_INF
  // (a label column clamped to 0 reads the blank's 0), as the ring holds it
  float blank, label[K / 2];
  auto fetch = [&](int j) {
    const int t = BETA ? T - 1 - j : j;
    const float* row = lp + static_cast<long long>(t) * Lp1;
    const bool live = t < out_len;
    blank = live ? __ldg(row) : 0.f;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const int c = min(max(BETA ? col0 - i : col0 + i, 0), L);
      label[i] = live ? __ldg(row + c) : (c == 0 ? 0.f : NEG_INF);
    }
  };
  fetch(0);

  for (int m = 0; m < n_chunks; ++m) {
    meet_halo<K>(x, halo + (m & 1) * n_warps * HALO_LANES * K, m, warp, lane);
    const int n = min(CHUNK, T - m * CHUNK);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int j = m * CHUNK + i;
      float e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = k & 1 ? label[k / 2] : blank;
      if (j + 1 < T) fetch(j + 1);
      chain_frame<K, BETA>(x, e, j == 0, o, keep, first, S, s_blank, s_label);
      o += row_step;
    }
  }
}

// blocks 0 .. B-1: alpha of item b; blocks B .. 2B-1 (when betas is given):
// beta of item b - B. Dynamic shared memory: the halo, two meets of
// n_warps * HALO_LANES * K floats.
template <int K>
__global__ void __launch_bounds__(direct_warps<K>() * 32)
ctc_chain_direct_kernel(const float* __restrict__ logprobs, const int* __restrict__ in_lens,
                        const int* __restrict__ out_lens, float* __restrict__ alphas,
                        float* __restrict__ betas, int B, int T, int L) {
  extern __shared__ float halo[];
  const bool beta = blockIdx.x >= B;
  const int b = beta ? blockIdx.x - B : blockIdx.x;
  const long long S = 2 * L + 1;
  const float* lp = logprobs + static_cast<long long>(b) * T * (L + 1);
  if (beta)
    run_chain_direct<K, true>(lp, betas + b * T * S, halo, T, L, in_lens[b], out_lens[b]);
  else
    run_chain_direct<K, false>(lp, alphas + b * T * S, halo, T, L, 0, out_lens[b]);
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

template <int K>
cudaError_t launch_direct(const float* logprobs, const int* in_lens, const int* out_lens,
                          float* alphas, float* betas, int B, int T, int L,
                          cudaStream_t stream) {
  const int warps = (2 * L + 1 + Layout<K>::OWN - 1) / Layout<K>::OWN;
  const size_t smem = sizeof(float) * 2 * warps * HALO_LANES * K;
  ctc_chain_direct_kernel<K><<<betas ? 2 * B : B, warps * 32, smem, stream>>>(
      logprobs, in_lens, out_lens, alphas, betas, B, T, L);
  return cudaGetLastError();
}

// two states a lane up to 8 warps (every training bucket), four up to the
// ring's reach, then the direct chains at eight and 32
cudaError_t launch_chains(const void* logprobs, const void* in_lens, const void* out_lens,
                          void* alphas, void* betas, int B, int T, int L, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || L <= 0 || 2 * L + 1 > MAX_S) return cudaErrorInvalidValue;
  const auto lp = static_cast<const float*>(logprobs);
  const auto il = static_cast<const int*>(in_lens), ol = static_cast<const int*>(out_lens);
  const auto al = static_cast<float*>(alphas), be = static_cast<float*>(betas);
  const int S = 2 * L + 1;
  if (S <= SHORT_S) return launch<K_SHORT>(lp, il, ol, al, be, B, T, L, stream);
  if (S <= RING_S) return launch<K_LONG>(lp, il, ol, al, be, B, T, L, stream);
  if (S <= WIDE_S) return launch_direct<K_WIDE>(lp, il, ol, al, be, B, T, L, stream);
  return launch_direct<K_HUGE>(lp, il, ol, al, be, B, T, L, stream);
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// The alpha chain alone (a forward that needs no gradient). Returns a
// cudaError_t code (0 on success).
extern "C" int ctc_alpha(const void* logprobs, const void* out_lens, void* alphas, int B, int T,
                         int L, void* stream) {
  return static_cast<int>(launch_chains(logprobs, nullptr, out_lens, alphas, nullptr, B, T, L,
                                        static_cast<cudaStream_t>(stream)));
}

// The alpha and beta chains side by side, one launch.
extern "C" int ctc_alpha_beta(const void* logprobs, const void* in_lens, const void* out_lens,
                              void* alphas, void* betas, int B, int T, int L, void* stream) {
  if (!betas) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_chains(logprobs, in_lens, out_lens, alphas, betas, B, T, L,
                                        static_cast<cudaStream_t>(stream)));
}

// The posterior gradient d(g . -ll)/d logprobs from the alpha and beta rows.
extern "C" int ctc_grad(const void* alphas, const void* betas, const void* out_lens,
                        const void* ll, const void* g, void* grad, int B, int T, int L,
                        void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || 2 * L + 1 > MAX_S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B * T + GRAD_ROWS - 1) / GRAD_ROWS;
  ctc_grad_kernel<<<blocks, GRAD_ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alphas), static_cast<const float*>(betas),
      static_cast<const int*>(out_lens), static_cast<const float*>(ll),
      static_cast<const float*>(g), static_cast<float*>(grad), B, T, L);
  return static_cast<int>(cudaGetLastError());
}
