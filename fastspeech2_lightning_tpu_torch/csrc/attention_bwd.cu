// Attention backward with dropout on the attention probabilities (the FA2
// backward), the gradient of attention_fwd.cu:
//
//   O = dropout_p(softmax(sm_scale * Q K^T + key_bias)) V
//   P     = exp(sm_scale * Q K^T + key_bias - lse)      (lse from the forward)
//   dP    = dO V^T
//   dprob = keep * dP / (1 - p)
//   dS    = P * (dprob - D),  D = rowsum(dO * O)          (D comes from torch)
//   dV = (keep * P / (1 - p))^T dO,  dK = sm_scale * dS^T Q,  dQ = sm_scale * dS K
//
// q, k, v, o, do: [B, H, T, dh] (any strides over B, H, T; dh contiguous);
// key_bias [B, T] f32; lse, D [B, H, T] f32; dq_acc [B, H, T, dh] f32
// contiguous, zeroed by the caller (summed into with atomicAdd); dk, dv
// [B, H, T, dh] contiguous in q's dtype. The key bias gets no gradient. The
// keep mask is regenerated from (seed, b*H + h, row, col) exactly as the
// forward drew it (common.cuh).
//
// Replaces three TPU kernels of the JAX package:
// fastspeech2_lightning_tpu/ops/attention_dropout.py:190 _attention_bwd
// (_bwd_kernel :80), and the streaming backward _stream_bwd :494 (dQ,
// _sbwd_dq_kernel :332, call :506; dK dV, _sbwd_dkv_kernel :375, call :543).
//
// Bound: 10*B*H*T^2*dh operations (five T x T x dh products) against about
// 8*B*H*T*dh elements moved; at the decoder's training shape (B=16, H=2,
// T=2048, dh=128, bf16) 172 GFLOP, about 174 us at the 989 TFLOP/s bf16
// tensor-core peak: compute-bound.
//
// Design (a simple first kernel, one launch): one block of 256 threads per
// (64-key tile, head, batch) keeps its K and V tiles in shared memory and the
// tile's [64, dh] dK and dV accumulators in registers (four threads per key
// row), and loops over the query tiles: it stages Q, dO, lse and D, recomputes
// the 64 x 64 tile of P and dP on the CUDA cores, regenerates the keep mask,
// accumulates dK and dV, and adds the tile's dQ contribution into the f32
// buffer with atomicAdd (so dQ's summation order varies from run to run).
// All arithmetic is f32 FMA: tensor cores and a pipelined tile ring are
// later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per block
constexpr int THREADS = 256;  // 4 threads per key (or query) row

struct Strides {
  long long b, h, t;
};

struct Dropout {
  const int* seed;
  uint32_t thresh;
  float keep_scale;
};

template <int DH>
constexpr size_t smem_floats() {
  // K, V, Q, dO tiles padded to DH + 1; P-kept and dS tiles [key][query]
  // padded to BQ + 1; key bias, lse, D.
  return 4 * 64 * (DH + 1) + 2 * BK * (BQ + 1) + BK + 2 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ key_bias, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dq_acc,
                     T* __restrict__ dk, T* __restrict__ dv, int T_len, Strides qs,
                     Strides ks, Strides vs, Strides ds, float sm_scale, Dropout drop) {
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
  const uint32_t key = drop.thresh ? fs2::dropout_key(*drop.seed, static_cast<int>(bh)) : 0u;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + bh * T_len;
  const float* dsum_b = dsum + bh * T_len;
  float* dq_b = dq_acc + bh * T_len * DH;

  for (int i = tid; i < BK * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, t = k0 + r;
    const bool ok = t < T_len;
    Ks[r * LD + d] = ok ? fs2::to_f32(kb[t * ks.t + d]) : 0.f;
    Vs[r * LD + d] = ok ? fs2::to_f32(vb[t * vs.t + d]) : 0.f;
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
      Qs[r * LD + d] = ok ? fs2::to_f32(qb[t * qs.t + d]) : 0.f;
      Ds[r * LD + d] = ok ? fs2::to_f32(db[t * ds.t + d]) : 0.f;
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
        const float p = expf(s[j] * sm_scale + bias - Ls[qc]);
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
      dk[off + 4 * m] = fs2::from_f32<T>(dk_acc[m] * sm_scale);
      dv[off + 4 * m] = fs2::from_f32<T>(dv_acc[m]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* bias, const float* lse, const float* dsum, float* dq_acc,
                   void* dk, void* dv, int B, int H, int T_len, Strides qs, Strides ks,
                   Strides vs, Strides ds, float sm_scale, Dropout drop,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BK - 1) / BK, H, B);
  attention_bwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), bias, lse, dsum, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), T_len, qs, ks, vs, ds, sm_scale, drop);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// Strides are in elements; dq_acc, dk, dv, lse and dsum are contiguous.
// `seed` may be null when thresh == 0. Returns a cudaError_t code.
extern "C" int attention_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* key_bias, const void* lse,
                             const void* dsum, const void* seed, void* dq_acc, void* dk,
                             void* dv, int B, int H, int T_len, int dh,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long d_sb, long long d_sh, long long d_st,
                             float sm_scale, long long thresh, float keep_scale,
                             void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, ds{d_sb, d_sh, d_st};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > 65536 || thresh < 0 || thresh > 0xffffffffLL ||
      (thresh > 0 && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{static_cast<const int*>(seed), static_cast<uint32_t>(thresh), keep_scale};
  const float* bias = static_cast<const float*>(key_bias);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(dsum);
  float* acc = static_cast<float*>(dq_acc);
  if (dtype == fs2::kFloat32 && dh == 64)
    return launch<float, 64>(q, k, v, dout, bias, l, dd, acc, dk, dv, B, H, T_len, qs, ks,
                             vs, ds, sm_scale, drop, st);
  if (dtype == fs2::kFloat32 && dh == 128)
    return launch<float, 128>(q, k, v, dout, bias, l, dd, acc, dk, dv, B, H, T_len, qs, ks,
                              vs, ds, sm_scale, drop, st);
  if (dtype == fs2::kBFloat16 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, bias, l, dd, acc, dk, dv, B, H, T_len,
                                     qs, ks, vs, ds, sm_scale, drop, st);
  if (dtype == fs2::kBFloat16 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, bias, l, dd, acc, dk, dv, B, H, T_len,
                                      qs, ks, vs, ds, sm_scale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
