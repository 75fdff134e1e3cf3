// Width-1 monotonic alignment search (MAS): the Viterbi path of a [T, L]
// log-attention map from (0, 0) to (out_len - 1, in_len - 1), moving at each
// mel frame either to the same text position or one to the right.
//
//   la     = valid ? max(log_attn, -1e9) : -1e9   (valid: i < out_len, j < in_len)
//   P[0,j] = la[0,j] + (j == 0 ? 0 : -1e9)
//   P[i,j] = max(la[i,j] + max(P[i-1,j], P[i-1,j-1]), -1e9)   (P[i-1,-1] = -1e9)
//   backtrack from (out_len - 1, in_len - 1): at row i step left iff
//   j > 0 and P[i-1,j-1] >= P[i-1,j]; frames >= out_len are zero
//   durations[j] = number of frames on column j
//
// log_attn [B, T, L] f32 contiguous; in_lens, out_lens [B] int32; outputs
// attn_hard [B, T, L] f32 (one-hot rows) and durations [B, L] int32; scratch
// bits [B, T, ceil(L/32)] uint32.
//
// Replaces fastspeech2_lightning_tpu/ops/mas_pallas.py:94 mas_width1_pallas
// (_mas_kernel :34), with the semantics of ops/mas.py:93-147. Adds and maxes
// in one fixed order are exact in f32, so the path equals the plain version's
// (ops/mas.py mas_width1_reference) bit for bit.
//
// Bound: read B*T*L*4 bytes and write B*T*L*4 bytes (plus B*L*4); at B=16,
// T=2048, L=1000 that is 262 MB, about 78 us at 3.35 TB/s: memory-bound.
//
// Design (a simple first kernel): one block per batch item, one thread per
// text position (L <= 1024). The DP row lives double-buffered in shared
// memory, one __syncthreads per mel frame. When row i is formed, each warp
// stores its 32 move decisions as one ballot word in global memory (T*L/8
// bytes per item): the DP table itself never reaches device memory. The
// block then zeroes its output and one thread walks the decision bits back
// from (out_len - 1, in_len - 1), writing the one-hot rows and the
// durations. The sequential frame loop and the one-thread backtrack, not
// the bytes, set this kernel's time.

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e9f;
constexpr int MAX_L = 1024;

__global__ void __launch_bounds__(MAX_L)
mas_width1_kernel(const float* __restrict__ log_attn, const int* __restrict__ in_lens,
                  const int* __restrict__ out_lens, float* __restrict__ hard,
                  int* __restrict__ durations, uint32_t* __restrict__ bits, int T, int L) {
  __shared__ float rows[2][MAX_L];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int W = (L + 31) / 32;
  const int in_len = in_lens[b];
  const int out_len = out_lens[b];
  const float* la = log_attn + static_cast<long long>(b) * T * L;
  uint32_t* bits_b = bits + static_cast<long long>(b) * T * W;
  const bool col = j < L;

  auto masked = [&](int i) {
    const bool valid = col && j < in_len && i < out_len;
    return valid ? fmaxf(la[static_cast<long long>(i) * L + j], NEG_INF) : NEG_INF;
  };

  if (col) rows[0][j] = masked(0) + (j == 0 ? 0.f : NEG_INF);
  __syncthreads();
  for (int i = 1; i < T; ++i) {
    const float* prev = rows[(i - 1) & 1];
    float stay = 0.f, left = NEG_INF;
    if (col) {
      stay = prev[j];
      if (j > 0) left = prev[j - 1];
    }
    const bool move = col && j > 0 && left >= stay;
    const uint32_t word = __ballot_sync(0xffffffffu, move);
    if ((j & 31) == 0 && j < L) bits_b[static_cast<long long>(i) * W + (j >> 5)] = word;
    if (col) rows[i & 1][j] = fmaxf(masked(i) + fmaxf(stay, left), NEG_INF);
    __syncthreads();
  }

  float* hard_b = hard + static_cast<long long>(b) * T * L;
  for (long long e = j; e < static_cast<long long>(T) * L; e += blockDim.x) hard_b[e] = 0.f;
  int* dur_b = durations + static_cast<long long>(b) * L;
  if (col) dur_b[j] = 0;
  __syncthreads();  // zeros and decision bits are visible to thread 0
  // as in the JAX package, lengths outside [1, L] leave the item all zero
  if (j == 0 && out_len > 0 && in_len > 0 && in_len <= L) {
    int c = in_len - 1;
    for (int i = out_len - 1; i >= 1; --i) {
      hard_b[static_cast<long long>(i) * L + c] = 1.f;
      dur_b[c] += 1;
      if (c > 0 && ((bits_b[static_cast<long long>(i) * W + (c >> 5)] >> (c & 31)) & 1u)) --c;
    }
    hard_b[c] = 1.f;
    dur_b[c] += 1;
  }
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// Returns a cudaError_t code (0 on success).
extern "C" int mas_width1(const void* log_attn, const void* in_lens, const void* out_lens,
                          void* hard, void* durations, void* bits, int B, int T, int L,
                          void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || L > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (L + 31) / 32 * 32;
  mas_width1_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_attn), static_cast<const int*>(in_lens),
      static_cast<const int*>(out_lens), static_cast<float*>(hard),
      static_cast<int*>(durations), static_cast<uint32_t*>(bits), T, L);
  return static_cast<int>(cudaGetLastError());
}
