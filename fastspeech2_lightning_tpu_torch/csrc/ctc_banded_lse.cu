// CTC forward-sum over blank-interleaved states s = 0..2L (label(s) = 0 for
// even s, (s + 1) / 2 for odd s): the alpha scan, and the beta scan fused
// with the posterior gradient.
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
// logprobs [B, T, L+1] f32 contiguous (column 0 blank); alphas [B, T, S]
// f32; in_lens, out_lens [B] int32; ll, g [B] f32; grad [B, T, L+1] f32.
//
// Replaces fastspeech2_lightning_tpu/ops/ctc_pallas.py:120
// banded_lse_scan_pallas (_make_kernel :34), run by ops/ctc.py:83-91 (alpha)
// and :173-188 (beta); the posterior gradient (ops/ctc.py:216-226) is fused
// into the beta pass, and the emission gather and padded-frame blank forcing
// (_uniform_logprobs, :42-48) into the loads.
//
// Bound: the alpha pass reads B*T*(L+1)*4 bytes and writes B*T*S*4; the beta
// pass reads both and writes B*T*(L+1)*4. At B=16, T=1024, L=160 that is
// about 32 MB in all, some 10 us at 3.35 TB/s; the 3*S exp and log per state
// and frame (under 0.1 GFLOP) do not bind either.
//
// Design (a simple first kernel): one block per batch item, the states
// across the threads (at most two states a thread, S <= 2048) and the live
// row double-buffered in shared memory, one or two __syncthreads per frame
// (plus a block sum of the even states for the blank column). T sequential
// frames of a 1-3 us round each, not the bytes, set the time.

#include <math.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e15f;
constexpr int MAX_S = 2048;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= 0.5f * NEG_INF) return NEG_INF;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float emit(const float* lp_t, int s, bool padded) {
  const int label = (s & 1) ? (s + 1) >> 1 : 0;
  if (padded) return label == 0 ? 0.f : NEG_INF;
  return lp_t[label];
}

__global__ void __launch_bounds__(1024)
ctc_alpha_kernel(const float* __restrict__ logprobs, const int* __restrict__ out_lens,
                 float* __restrict__ alphas, int T, int L) {
  __shared__ float rows[2][MAX_S];
  const int b = blockIdx.x;
  const int S = 2 * L + 1, Lp1 = L + 1;
  const int out_len = out_lens[b];
  const float* lp = logprobs + static_cast<long long>(b) * T * Lp1;
  float* al = alphas + static_cast<long long>(b) * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) rows[1][s] = s == 0 ? 0.f : NEG_INF;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* prev = rows[(t + 1) & 1];
    float* cur = rows[t & 1];
    const float* lp_t = lp + static_cast<long long>(t) * Lp1;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float a1 = s >= 1 ? prev[s - 1] : NEG_INF;
      const float a2 = (s & 1) && s >= 2 ? prev[s - 2] : NEG_INF;
      const float v = fmaxf(lse3(prev[s], a1, a2) + emit(lp_t, s, t >= out_len), NEG_INF);
      cur[s] = v;
      al[static_cast<long long>(t) * S + s] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024)
ctc_beta_grad_kernel(const float* __restrict__ logprobs, const float* __restrict__ alphas,
                     const int* __restrict__ in_lens, const int* __restrict__ out_lens,
                     const float* __restrict__ ll, const float* __restrict__ g,
                     float* __restrict__ grad, int T, int L) {
  __shared__ float beta[MAX_S];
  __shared__ float w[MAX_S];
  __shared__ float partial[32];
  const int b = blockIdx.x;
  const int S = 2 * L + 1, Lp1 = L + 1;
  const int out_len = out_lens[b];
  const int s_blank = min(max(2 * in_lens[b], 0), S - 1);
  const int s_label = min(max(2 * in_lens[b] - 1, 0), S - 1);
  const float llb = ll[b], gb = g[b];
  const float* lp = logprobs + static_cast<long long>(b) * T * Lp1;
  const float* al = alphas + static_cast<long long>(b) * T * S;
  float* gr = grad + static_cast<long long>(b) * T * Lp1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  for (int s = threadIdx.x; s < S; s += blockDim.x)
    beta[s] = (s == s_blank || s == s_label) ? 0.f : NEG_INF;
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float* gr_t = gr + static_cast<long long>(t) * Lp1;
    const bool live = t < out_len;
    // posterior gradient at frame t
    float even = 0.f;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float x = fminf(fmaxf(al[static_cast<long long>(t) * S + s] + beta[s] - llb, -80.f), 0.f);
      const float gamma = expf(x);
      if (s & 1)
        gr_t[(s + 1) >> 1] = live ? -gamma * gb : 0.f;
      else
        even += gamma;
    }
    for (int off = 16; off > 0; off >>= 1) even += __shfl_xor_sync(0xffffffffu, even, off);
    if (lane == 0) partial[warp] = even;
    // w = beta_t + emit_t, the input of beta_{t-1}
    const float* lp_t = lp + static_cast<long long>(t) * Lp1;
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      w[s] = beta[s] + emit(lp_t, s, !live);
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < nwarps; ++i) sum += partial[i];
      gr_t[0] = live ? -sum * gb : 0.f;
    }
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float w1 = s + 1 < S ? w[s + 1] : NEG_INF;
      const float w2 = (s & 1) && s + 2 < S ? w[s + 2] : NEG_INF;
      beta[s] = fmaxf(lse3(w[s], w1, w2), NEG_INF);
    }
    __syncthreads();
  }
}

int threads_for(int S) { return min(1024, (S + 31) / 32 * 32); }

}  // namespace

FS2_EXPORT_ERROR_STRING

// Returns a cudaError_t code (0 on success).
extern "C" int ctc_alpha(const void* logprobs, const void* out_lens, void* alphas, int B, int T,
                         int L, void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T <= 0 || L <= 0 || S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  ctc_alpha_kernel<<<B, threads_for(S), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logprobs), static_cast<const int*>(out_lens),
      static_cast<float*>(alphas), T, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_beta_grad(const void* logprobs, const void* alphas, const void* in_lens,
                             const void* out_lens, const void* ll, const void* g, void* grad,
                             int B, int T, int L, void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T <= 0 || L <= 0 || S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  ctc_beta_grad_kernel<<<B, threads_for(S), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logprobs), static_cast<const float*>(alphas),
      static_cast<const int*>(in_lens), static_cast<const int*>(out_lens),
      static_cast<const float*>(ll), static_cast<const float*>(g), static_cast<float*>(grad),
      T, L);
  return static_cast<int>(cudaGetLastError());
}
