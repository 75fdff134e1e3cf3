// One convolution of the HiFiGAN multi-receptive-field (MRF) stage, with its
// leaky ReLU in front and its residual and stage-average epilogue behind:
//
//   y[b, t, co] = bias[co] + sum_tap sum_ci lrelu(x[b, t + (tap - half) * d, ci])
//                                           * w[tap, ci, co]   (+ res[b, t, co])
//   mode 0: out = y        mode 1: acc += scale * y        mode 2: out = acc + scale * y
//
// over x, res, out: [B, T, C] (contiguous), w: [K, C, C], bias: [C] in the
// input dtype and acc: [B, T, C] f32. Positions outside [0, T) read as zero,
// as SAME padding gives (lrelu(0) = 0). `res` may alias `out`: each output
// element reads its own residual before it writes.
//
// Replaces fastspeech2_lightning_tpu/ops/vocoder_resblocks.py:168
// fused_mrf_stage (_mrf_kernel :92), which computes a whole stage
//   y = mean_j RB_j(x),  RB_j: for each dilation i,
//   x += conv_{k_j,1}(lrelu(conv_{k_j,d_i}(lrelu(x))))
// in one launch. The stage wrapper (ops/vocoder_resblocks.py) launches this
// kernel 18 times for a HiFiGAN V1 stage (kernels 3, 7, 11 x dilations
// 1, 3, 5 x 2 convs); the TPU's single launch with a 64-row halo needs two
// (block_t + 128) x C f32 buffers, which at C = 128 fit 227 KB of shared
// memory only at block_t <= 32, with 5x halo recompute. That redesign is
// queued.
//
// Bound: a stage does 2 * B * T * C^2 * 126 operations on 2 * B * T * C
// elements moved, so it is compute-bound at every C of the V1 stages.
//
// Design (a simple first kernel): an implicit GEMM, M = time, N = output
// channels, reduction over (tap, input channel). A block of 256 threads
// computes a 64 t x 64 co tile, 4 x 4 outputs a thread, walking 16-channel
// slices of each tap: the shifted, leaky-ReLU'd input rows and the weight
// slice are staged in shared memory as f32, products accumulate in f32
// registers on the CUDA cores. Tensor cores and a pipelined tile ring are
// later work.

#include "common.cuh"

namespace {

constexpr int BT = 64;        // time rows per block
constexpr int BCO = 64;       // output channels per block
constexpr int BCI = 16;       // input channels per reduction step
constexpr int THREADS = 256;  // 16 x 16, each 4 x 4 outputs
constexpr float LRELU_SLOPE = 0.1f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mrf_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, const T* res, T* out, float* acc,
                int T_len, int C, int K, int dil, int mode, float scale) {
  __shared__ float As[BCI][BT + 4];
  __shared__ float Ws[BCI][BCO];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int t0 = blockIdx.x * BT;
  const int co0 = blockIdx.y * BCO;
  const long long b = blockIdx.z;
  const T* xb = x + b * T_len * C;
  const int half = (K - 1) / 2;

  float sum[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;

  for (int tap = 0; tap < K; ++tap) {
    const int off = (tap - half) * dil;
    const T* wt = w + static_cast<long long>(tap) * C * C;
    for (int ci0 = 0; ci0 < C; ci0 += BCI) {
      for (int i = tid; i < BT * BCI; i += THREADS) {
        const int ci = i % BCI, tt = i / BCI;
        const int t = t0 + tt + off, c = ci0 + ci;
        float a = 0.f;
        if (t >= 0 && t < T_len && c < C) {
          a = fs2::to_f32(xb[static_cast<long long>(t) * C + c]);
          a = a > 0.f ? a : a * LRELU_SLOPE;
        }
        As[ci][tt] = a;
      }
      for (int i = tid; i < BCI * BCO; i += THREADS) {
        const int co = i % BCO, ci = i / BCO;
        const int c = ci0 + ci, o = co0 + co;
        Ws[ci][co] = (c < C && o < C) ? fs2::to_f32(wt[static_cast<long long>(c) * C + o]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BCI; ++kk) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[i][j] = fmaf(a[i], bw[j], sum[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = co0 + tx + 16 * j;
      if (o >= C) continue;
      const long long idx = (b * T_len + t) * C + o;
      float y = sum[i][j] + fs2::to_f32(bias[o]);
      if (res != nullptr) y += fs2::to_f32(res[idx]);
      if (mode == 0) {
        out[idx] = fs2::from_f32<T>(y);
      } else if (mode == 1) {
        acc[idx] += scale * y;
      } else {
        out[idx] = fs2::from_f32<T>(acc[idx] + scale * y);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* res,
                   void* out, void* acc, int B, int T_len, int C, int K, int dil,
                   int mode, float scale, cudaStream_t stream) {
  const dim3 grid((T_len + BT - 1) / BT, (C + BCO - 1) / BCO, B);
  mrf_conv_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), static_cast<float*>(acc), T_len,
      C, K, dil, mode, scale);
  return cudaGetLastError();
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// res may be null; out is unused in mode 1 and acc in mode 0.
// Returns a cudaError_t code (0 on success).
extern "C" int mrf_conv(int dtype, const void* x, const void* w, const void* bias,
                        const void* res, void* out, void* acc, int B, int T_len, int C,
                        int K, int dil, int mode, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || C <= 0 || K <= 0 || dil <= 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == fs2::kFloat32)
    return launch<float>(x, w, bias, res, out, acc, B, T_len, C, K, dil, mode, scale, st);
  if (dtype == fs2::kBFloat16)
    return launch<__nv_bfloat16>(x, w, bias, res, out, acc, B, T_len, C, K, dil, mode,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
