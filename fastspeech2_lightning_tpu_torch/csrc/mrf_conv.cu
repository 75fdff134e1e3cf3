// One convolution of the HiFiGAN multi-receptive-field (MRF) stage, with its
// leaky ReLU in front and its residual and stage-average epilogue behind:
//
//   y[b, t, co] = bias[co] + sum_tap sum_ci lrelu(x[b, t + tap * d - left, ci])
//                                           * w[tap, ci, co]   (+ res[b, t, co])
//   left = ((K - 1) * d) / 2   (SAME padding; (K - 1) / 2 * d for odd K)
//   mode 0: out = y        mode 1: acc += scale * y        mode 2: out = acc + scale * y
//
// over x, res, out: [B, T, C] (contiguous) and bias: [C] in the input dtype
// (bf16 or f32), C = 16, 32, 64 or 128, and acc: [B, T, C] f32; the span
// (K - 1) * d at most 126, which every conv of a stage that the JAX
// package's gate fuses (a chain within its 64-row halo) keeps to with an odd
// K. ops/vocoder_resblocks.py pads any other C <= 128 that takes this
// route with zero channels up to the next of these widths. The weights are
// always bf16: w [K, C, C] (tap, in, out) for bf16 inputs, and for f32 inputs
// [2, K, C, C], the f32 weights split into a high and a low bf16 part
// (w = w_hi + w_lo to 2^-16; ops/vocoder_resblocks.py prepare_stage_weights).
// Positions outside [0, T) read as zero, as SAME padding gives
// (lrelu(0) = 0). `res` may alias `out`: each output element reads its own
// residual before it writes. `x` must not alias `out`: a block reads rows
// that its neighbours write.
//
// Replaces fastspeech2_lightning_tpu/ops/vocoder_resblocks.py:168
// fused_mrf_stage (_mrf_kernel :92), which computes a whole stage
//   y = mean_j RB_j(x),  RB_j: for each dilation i,
//   x += conv_{k_j,1}(lrelu(conv_{k_j,d_i}(lrelu(x))))
// in one launch, each conv as a tap-stacked product [rows, k C] x [k C, C].
// The stage wrapper (ops/vocoder_resblocks.py mrf_conv_chain) launches this
// kernel 18 times for a stage of C 32 to 128 (kernels 3, 7, 11 x dilations
// 1, 3, 5 x 2 convs: HiFiGAN V1's stages, V2's C 64 and 32). A stage of
// C <= 16 is one launch of csrc/mrf_stage.cu, which keeps the whole chain on
// chip; this kernel's C 16 build stays for the narrow stages that one does
// not take (an even k whose chain reaches past its 64-row halo), at C 1 to
// 16 zero-padded to 16. The C 32 to 128 stages in one launch are queued
// (ROADMAP.md).
//
// Bound: a stage does 2 * B * T * C^2 * 126 operations on 2 * B * T * C
// elements moved, so it is compute-bound at every C of the V1 stages.
//
// Design: an implicit GEMM on the tensor cores. A block of two warpgroups
// computes 128 time rows x all C output channels (wgmma m64nCk16, bf16 in,
// f32 accumulators in registers), reducing over (tap, input channel) in
// steps of 16; for f32 at C = 128, four warpgroups and 256 rows (Tiling).
//  - The input tile is read from device memory once, with its halo: rows
//    t0 - left .. t0 + 127 + (K - 1) * d - left, zero outside [0, T), leaky-ReLU'd
//    on the way and stored as bf16 rows of C + 8 elements. Tap `tap` of
//    output row r is tile row r + tap * d.
//  - A comes from registers, not from a shared-memory descriptor: dilations
//    1, 3, 5 shift the rows by odd counts, which the 8-row period of a
//    swizzled descriptor tile does not allow without its base-offset field.
//    At C = 16 the products are one warp's mma.sync m16n8k16 pairs on the
//    same fragments (wgmma's narrowest B in a swizzled tile is 32 wide), B
//    from a row-major weight tile (rows padded to 24 elements) by
//    ldmatrix.trans; those stages move 2 bytes for about 2 * 16 * K
//    operations an element, far below the card's 295 a byte, so the narrower
//    product costs nothing there.
//    ldmatrix.x4 reads the 16 x 16 fragment at any row; the 16 bytes of
//    padding a row put the 8 rows of each 8 x 8 block on different banks at
//    every C.
//  - B (the weights) streams from L2 in chunks of 64 reduction rows x C
//    through a three-stage cp.async ring of swizzled tiles (128-byte swizzle
//    at C = 64 and 128, 64-byte at C = 32), read by descriptor with the
//    transpose flag, like V in the attention kernels. One __syncthreads a
//    chunk; the chunk two ahead is in flight under this chunk's products.
//    A last chunk that is half empty (C = 32, odd K) is zero-filled.
//  - f32 inputs keep f32 accuracy on the same bf16 path: the activation is
//    split after the leaky ReLU into a_hi + a_lo (two bf16 tiles), and each
//    k-step runs three products, a_hi w_hi + a_lo w_hi + a_hi w_lo; the
//    term a_lo w_lo (2^-16 of the sum) is dropped. Measured against the f32
//    plain version: see PERF.md.
//  - Epilogue from the accumulator layout (tensor_core.cuh), two
//    neighbouring channels a store.
//  - Two builds of each (dtype, C): the input tile sized for spans up to 50
//    (HiFiGAN V1 and V2: kernel 11 at dilation 5), and for spans up to 126
//    (a conv of JAX's gate past 50, such as kernel 7 at dilation 9), where
//    the f32 C = 128 tiling falls back to 128 rows to fit.
// What limits it is not the tensor cores (29 to 42 % of their rate at
// C = 128) but how many blocks a multiprocessor holds to hide each block's
// phases behind another's (tile fill, per-chunk barrier, epilogue): a bf16
// block takes 97 KB at C = 128 and under 60 KB below, so two to four fit;
// anything that cost a block (more registers, a deeper ring) lost more than
// it won. f32 at C = 128 needs 191 KB for 128 rows, so one block fits
// whatever the tiling, and there 256 rows a block (with 32-row chunks, to
// fit 212 KB) won: every block streams the whole conv's weights, so twice
// the rows halve that traffic.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using fs2::tc::bf16;

// the span (K - 1) * dilation of a conv: what the narrow build's input tile
// takes (kernel 11 at dilation 5), and the most any build takes. Compiled
// with -DFS2_MRF_NARROW_SPAN=126 the source has one build, the wide one
// (tools/mrf_span_builds.py times the two against each other).
#ifndef FS2_MRF_NARROW_SPAN
#define FS2_MRF_NARROW_SPAN 50
#endif
constexpr int NARROW_SPAN = FS2_MRF_NARROW_SPAN;
constexpr int MAX_SPAN = 126;
constexpr float LRELU_SLOPE = 0.1f;

// The tiling for inputs of type T, C channels and spans up to MAXH (each
// choice at spans up to 50 measured against its neighbours on the H100;
// PERF.md).
template <typename T, int C, int MAXH>
struct Tiling {
  static constexpr bool SPLIT = sizeof(T) == 4;
  // time rows per block, one m64 warpgroup for every 64 (at f32 C = 128, 256
  // rows where the input tile leaves room: spans up to 50)
  static constexpr int BM = SPLIT && C == 128 && MAXH <= 50 ? 256 : 128;
  static constexpr int THREADS = 2 * BM;
  // reduction rows (tap, input channel) per weight chunk
  static constexpr int KC = SPLIT && C == 128 ? 32 : 64;
  // weight chunks in the ring
  static constexpr int STAGES = 3;
  // a weight tile's row stride: C (swizzled), or 24 at C = 16 (row-major,
  // padded so ldmatrix's 8 rows fall on different banks)
  static constexpr int WS = C == 16 ? 24 : C;
  // 1024 bytes to align the weight tiles to the swizzle period; per bf16 part
  // (one for bf16 inputs, high and low for f32): the ring of weight chunks
  // and the input tile with its halo, rows padded by 8 elements
  static constexpr size_t SMEM =
      1024 + (SPLIT ? 2 : 1) * (STAGES * KC * WS + (BM + MAXH) * (C + 8)) * sizeof(bf16);
  // blocks a multiprocessor holds at the least (the compiler's register budget)
  static constexpr int BLOCKS = SPLIT ? 1 : 2;
};

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : v * LRELU_SLOPE; }

// lrelu of 8 consecutive input elements (zero when !ok), as bf16 pairs: the
// value itself for bf16 inputs; for f32 inputs its high part in hi[] and the
// bf16-rounded remainder in lo[]
__device__ __forceinline__ void load8(const bf16* p, bool ok, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (ok) raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t r[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[i]));
    hi[i] = fs2::tc::pack_bf16(lrelu(v.x), lrelu(v.y));
    lo[i] = 0u;
  }
}

__device__ __forceinline__ void load8(const float* p, bool ok, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;
  if (ok) {
    u = *reinterpret_cast<const float4*>(p);
    v = *reinterpret_cast<const float4*>(p + 4);
  }
  const float a[8] = {lrelu(u.x), lrelu(u.y), lrelu(u.z), lrelu(u.w),
                      lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = fs2::tc::pack_bf16(a[2 * i] - hf.x, a[2 * i + 1] - hf.y);
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = fs2::tc::pack_bf16(a, b);
}

// reduction rows row0 .. row0 + KC - 1 of w [rows_total, C] into a tile of
// the ring (NT threads): swizzled, or at C = 16 row-major with rows of 24
// elements; rows at or past rows_total are zero-filled
template <int C, int KC, int NT>
__device__ __forceinline__ void load_w_tile(bf16* tile, const bf16* w, int row0,
                                            int rows_total, int tid) {
  if constexpr (C == 16) {
    static_assert(KC * 2 <= NT, "one 16-byte copy a thread");
    const int r = tid >> 1, c = tid & 1, row = row0 + r;  // KC rows x 2 chunks
    const bool ok = row < rows_total;
    if (r < KC) fs2::tc::cp_async16(tile + r * 24 + c * 8, w + (ok ? row : 0) * C + c * 8, ok);
  } else if constexpr (C == 32) {
    static_assert(KC * 4 <= NT, "one 16-byte copy a thread");
    const int r = tid >> 2, c = tid & 3, row = row0 + r;  // KC rows x 4 chunks
    const bool ok = row < rows_total;
    if (r < KC)
      fs2::tc::cp_async16(tile + fs2::tc::sw64(r, c), w + (ok ? row : 0) * C + c * 8, ok);
  } else {
    fs2::tc::load_tile<KC, C, NT>(tile, w, C, row0, rows_total, tid);
  }
}

// acc += A(registers) * (k-step kk of a weight tile of KC rows)
template <int C, int KC>
__device__ __forceinline__ void product(float (&acc)[C / 8][4], const uint32_t (&a)[4],
                                        const bf16* tile, int kk, int lane) {
  if constexpr (C == 16)
    fs2::tc::mma_rs_n16(acc, a, tile + kk * 16 * 24, 24, lane);
  else if constexpr (C == 32)
    fs2::tc::wgmma_rs_n32(acc, a, fs2::tc::sw64_desc(tile + kk * 16 * 32));
  else if constexpr (C == 64)
    fs2::tc::wgmma_rs_n64(acc, a, fs2::tc::sw128_desc(tile + kk * 16 * 64, KC * 128, 1024));
  else
    fs2::tc::wgmma_rs_n128(acc, a, fs2::tc::sw128_desc(tile + kk * 16 * 64, KC * 128, 1024));
}

template <typename T, int C, int MAXH>
__global__ void __launch_bounds__(Tiling<T, C, MAXH>::THREADS, Tiling<T, C, MAXH>::BLOCKS)
mrf_conv_kernel(const T* __restrict__ x, const bf16* __restrict__ w,
                const T* __restrict__ bias, const T* res, T* out, float* acc_buf,
                int T_len, int K, int dil, int mode, float scale) {
  using namespace fs2::tc;
  using Tile = Tiling<T, C, MAXH>;
  constexpr bool SPLIT = Tile::SPLIT;
  constexpr int BM = Tile::BM, THREADS = Tile::THREADS, KC = Tile::KC, STAGES = Tile::STAGES;
  constexpr int NL = SPLIT ? 2 : 1;   // bf16 parts of a value
  constexpr int AS = C + 8;           // input tile row stride, elements
  constexpr int ATILE = (BM + MAXH) * AS;
  constexpr int WTILE = KC * Tile::WS;
  constexpr int CH = C / 8;           // 8-element chunks of a row
  constexpr int NB = C / 8;           // n-blocks of the accumulator
  extern __shared__ unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* As = Ws + STAGES * NL * WTILE;  // [NL][ATILE]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BM;
  const long long b = blockIdx.y;
  const int left = (K - 1) * dil / 2;  // input rows before the output row (SAME)
  const int red_rows = K * C;                      // reduction length
  const int n_chunks = (red_rows + KC - 1) / KC;

  auto load_w = [&](int chunk) {
    bf16* dst = Ws + (chunk % STAGES) * NL * WTILE;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      load_w_tile<C, KC, THREADS>(dst + l * WTILE, w + static_cast<long long>(l) * red_rows * C,
                     chunk * KC, red_rows, tid);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {  // one group a chunk, empty past the last
    if (i < n_chunks) load_w(i);
    cp_async_commit();
  }

  // the input tile, once: lrelu(x) rows t0 - left .. t0 + BM - 1 + span - left
  const T* xb = x + b * T_len * C;
  const int n_fill = (BM + (K - 1) * dil) * CH;
#pragma unroll 4
  for (int i = tid; i < n_fill; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int t = t0 - left + r;
    const bool ok = t >= 0 && t < T_len;
    uint32_t hi[4], lo[4];
    load8(xb + static_cast<long long>(ok ? t : 0) * C + c * 8, ok, hi, lo);
    *reinterpret_cast<uint4*>(As + r * AS + c * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (SPLIT)
      *reinterpret_cast<uint4*>(As + ATILE + r * AS + c * 8) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // this lane's ldmatrix row address within a 16 x 16 fragment of its warp's
  // 16 output rows (warp w of the block: rows 16 w .. 16 w + 15)
  const bf16* a_lane = As + (warp * 16 + (lane & 15)) * AS + (lane >> 4) * 8;

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<STAGES - 2>();  // chunk i landed
    fence_async_shared();
    __syncthreads();              // ... for every thread, and chunk i - 1 is consumed
    if (i + STAGES - 1 < n_chunks) load_w(i + STAGES - 1);  // where chunk i - 1 was
    cp_async_commit();
    const bf16* Wt = Ws + (i % STAGES) * NL * WTILE;

    uint32_t a[NL][KC / 16][4];
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const int red = i * KC + kk * 16;
      // past the last tap (a half-empty last chunk) the weights are zero:
      // read any finite row
      const int tap = min(red / C, K - 1);
      const bf16* p = a_lane + tap * dil * AS + red % C;
      ldmatrix_x4(a[0][kk], p);
      if (SPLIT) ldmatrix_x4(a[NL - 1][kk], p + ATILE);
    }
    if constexpr (C != 16) wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      product<C, KC>(acc, a[0][kk], Wt, kk, lane);
      if (SPLIT) {
        product<C, KC>(acc, a[NL - 1][kk], Wt, kk, lane);
        product<C, KC>(acc, a[0][kk], Wt + WTILE, kk, lane);
      }
    }
    if constexpr (C != 16) {
      wgmma_commit();
      wgmma_wait<0>();
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + warp * 16 + g + 8 * h;
    if (t >= T_len) continue;
    const long long row = (b * T_len + t) * C + 2 * t4;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const long long idx = row + n * 8;
      const float2 bv = load2(bias + n * 8 + 2 * t4);
      float y0 = acc[n][2 * h] + bv.x, y1 = acc[n][2 * h + 1] + bv.y;
      if (res != nullptr) {
        const float2 rv = load2(res + idx);
        y0 += rv.x;
        y1 += rv.y;
      }
      if (mode == 0) {
        store2(out + idx, y0, y1);
      } else {
        const float2 av = load2(acc_buf + idx);
        if (mode == 1)
          store2(acc_buf + idx, av.x + scale * y0, av.y + scale * y1);
        else
          store2(out + idx, av.x + scale * y0, av.y + scale * y1);
      }
    }
  }
}

template <typename T, int C, int MAXH>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* res,
                   void* out, void* acc, int B, int T_len, int K, int dil, int mode,
                   float scale, cudaStream_t stream) {
  using Tile = Tiling<T, C, MAXH>;
  constexpr size_t smem = Tile::SMEM;
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, mrf_conv_kernel<T, C, MAXH>, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + Tile::BM - 1) / Tile::BM, B);
  mrf_conv_kernel<T, C, MAXH><<<grid, Tile::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), static_cast<float*>(acc), T_len, K,
      dil, mode, scale);
  return cudaGetLastError();
}

template <typename T, int MAXH>
cudaError_t launch_c(const void* x, const void* w, const void* bias, const void* res,
                     void* out, void* acc, int B, int T_len, int C, int K, int dil,
                     int mode, float scale, cudaStream_t stream) {
#define FS2_MRF_C(CC) \
  if (C == CC)        \
    return launch<T, CC, MAXH>(x, w, bias, res, out, acc, B, T_len, K, dil, mode, scale, stream);
  FS2_MRF_C(16)
  FS2_MRF_C(32)
  FS2_MRF_C(64)
  FS2_MRF_C(128)
#undef FS2_MRF_C
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_span(const void* x, const void* w, const void* bias, const void* res,
                        void* out, void* acc, int B, int T_len, int C, int K, int dil,
                        int mode, float scale, cudaStream_t stream) {
  if ((K - 1) * dil <= NARROW_SPAN)
    return launch_c<T, NARROW_SPAN>(x, w, bias, res, out, acc, B, T_len, C, K, dil, mode,
                                    scale, stream);
  return launch_c<T, MAX_SPAN>(x, w, bias, res, out, acc, B, T_len, C, K, dil, mode, scale,
                               stream);
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// `w` is bf16 [K, C, C] for dtype bf16 and bf16 [2, K, C, C] (high, low) for
// dtype f32. res may be null; out is unused in mode 1 and acc in mode 0.
// Returns a cudaError_t code (0 on success).
extern "C" int mrf_conv(int dtype, const void* x, const void* w, const void* bias,
                        const void* res, void* out, void* acc, int B, int T_len, int C,
                        int K, int dil, int mode, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || T_len <= 0 || K <= 0 || dil <= 0 || (K - 1) * dil > MAX_SPAN ||
      mode < 0 || mode > 2 || x == out)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == fs2::kFloat32)
    return launch_span<float>(x, w, bias, res, out, acc, B, T_len, C, K, dil, mode, scale, st);
  if (dtype == fs2::kBFloat16)
    return launch_span<bf16>(x, w, bias, res, out, acc, B, T_len, C, K, dil, mode, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
