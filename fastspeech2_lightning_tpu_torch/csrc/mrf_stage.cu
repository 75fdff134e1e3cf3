// A whole HiFiGAN multi-receptive-field (MRF) stage in one launch, for
// stages of 8 or 16 channels:
//
//   y = (1 / J) sum_j RB_j(x),   RB_j: s = x; for each dilation d of resblock j:
//       t = b1 + conv_{k_j, d}(lrelu(s));   s += b2 + conv_{k_j, 1}(lrelu(t))
//
// over x, y: [B, T, C] (contiguous, f32 or bf16), C = 8 or 16. Every conv
// pads as SAME does, (k - 1) * d / 2 rows before, and its input is zero
// outside [0, T): after each conv the rows of t and s outside [0, T) are
// set to zero again, or a bias would leak into them near both ends (the JAX
// kernel's `* in_range`). The weights are ops/vocoder_resblocks.py
// prepare_stage_weights's flat list, unchanged: per conv bf16 [k, C, C]
// (tap, in, out) for bf16 x, and for f32 x the split pair [2, k, C, C]
// (w = w_hi + w_lo to 2^-16); biases [C] in x's dtype. `y` must not alias
// `x`: a block reads rows around its own that its neighbours write.
//
// Replaces fastspeech2_lightning_tpu/ops/vocoder_resblocks.py:168
// fused_mrf_stage (_mrf_kernel :92) at C <= 16, as the JAX kernel does it:
// x read once with a 64-row halo, every intermediate on chip, y written
// once. csrc/mrf_conv.cu takes the stages of C 32 to 128 one conv a launch
// (18 a stage), and the narrow stages this kernel does not take (an even k
// whose chain reaches past the halo).
//
// Bound: a stage does 2 * B * T * C^2 * (sum of its convs' k) multiply-adds
// times 2 operations (126 taps for kernels 3, 7, 11 at three dilations) on
// 2 * B * T * C elements moved: 504 operations a byte at C 16 in f32, above
// the card's 295, so the bound is the tensor cores' (three bf16 products a
// multiply-add in f32); at C 8 in bf16 it is 504 too.
//
// Design:
//  - Grid: one block of 8 warps takes BM output rows of one utterance and
//    computes every conv over the BM + 128 rows t0 - 64 .. t0 + BM + 63, the
//    JAX kernel's halo of 64 (HALO). A chain wrongs at most its one-sided
//    reach (the sum of both convs' SAME extents over its dilations) rows at
//    each tile edge, so a stage whose deepest chain reaches at most 64 rows
//    is exact on the BM central rows. A tap that falls off the tile reads
//    the nearest tile row (finite, inside the wronged margin).
//  - Each warp owns G groups of 16 rows for the whole stage: one of the 8
//    halo groups and G - 1 of the BM / 16 output groups. s (the resblock
//    state) stays in f32 in that warp's registers, in the accumulator
//    layout, and so does the resblock sum of its output rows; x is read
//    from device memory into s at each resblock's start (three times a V1
//    or V2 stage, from L2 after the first) and y written once at the end.
//  - The convs' A operand is lrelu(s) or lrelu(t) as bf16 tiles in shared
//    memory (for f32 x a high and a low tile: a = a_hi + a_lo to 2^-16),
//    two of them: conv 1 reads P (lrelu(s)) and writes Q (lrelu(t)), conv 2
//    reads Q and writes P. One __syncthreads a conv orders them, and also
//    hands over the conv's weights.
//  - Products: one warp's mma.sync m16n8k16 (bf16 in, f32 accumulators),
//    not wgmma: a wgmma B tile narrower than 32 exists only unswizzled, and
//    its A from registers would still need the per-lane row addresses below,
//    so the warpgroup form buys nothing at n 8 or 16. A comes from
//    registers by ldmatrix, as in mrf_conv.cu, because the dilations shift
//    rows by odd counts: each lane gives the row address of its fragment
//    row, tap * d - left rows down. At C 16 a k-step is one tap; at C 8 it
//    spans two taps, so lanes 16-31 (the fragment's upper 8 columns) point
//    one tap further, and an odd k's half-empty last step reads a zero
//    weight tap. Tiles are 16 (C 16) or 8 (C 8) elements a row, unpadded:
//    at C 16 the two 16-byte chunks of a row swap on every other 4-row
//    group, so the 8 rows ldmatrix reads from any start fall on distinct
//    banks; at C 8 eight rows are 128 contiguous bytes.
//  - f32 keeps the three-product split of mrf_conv.cu: a_hi w_hi + a_lo w_hi
//    + a_hi w_lo, the term a_lo w_lo (2^-16 of the sum) dropped; s, t (before
//    its split) and the resblock sum stay f32. bf16 keeps them in f32 too,
//    so it is closer to an f32 stage than the 18-launch chain, which stored
//    t and s in bf16 between convs.
//  - Weights: each conv's [k, C, C] (both parts) goes by cp.async into one
//    of two shared buffers while the conv before it computes; B fragments
//    come by ldmatrix.trans once a k-step and serve the warp's G groups.
//    The buffers are sized for the stage's widest conv (k up to 65, the
//    most a reach of 64 admits: 133 KB for two f32 buffers at C 16).
//  - G = 4 at C 16 (BM 384) and 6 at C 8 (BM 640): 1.33x and 1.2x the
//    output rows' products, at 118-127 registers, two blocks an SM.
//    tools/mrf_stage_tiles.py times the other choices (PERF.md): fewer
//    groups cost up to 1.5x (halo work), more spill (G 5 at C 16) or gain
//    under 4 %.
// What limits it (H100, V2's stages at B 8, 896 frames: 8-18 % of the
// bound) is neither device memory (x is read (BM + 128) / BM times, then
// from L2) nor the tensor cores (in f32 about 0.26 m16n8k16 products a
// cycle an SM, counted over the measured time, where the bf16 peak is
// about one; less in bf16) but, by instruction count, the instructions
// spent around the products: each conv's epilogue (bias, the [0, T) mask,
// leaky ReLU, the bf16 split, two shared stores a value pair: about 20
// instructions for 2 values, 18 times a stage) and the A fragments' row
// addresses, against 2 (bf16) or 6 (f32) products per group and tap. At k
// 3 the epilogue outweighs the products. (Not measured by counter: ncu
// does not run where the card is.)

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using fs2::tc::bf16;

constexpr int HALO = 64;       // rows each side of a block's output rows
constexpr int MAX_PAIRS = 32;  // conv pairs (dilations over all resblocks) a stage
constexpr int MAX_K = 65;      // the widest conv a reach of 64 admits (k 65 at dilation 1)
constexpr float LRELU_SLOPE = 0.1f;
constexpr int FIRST = 1, LAST = 2;  // a pair's place in its resblock

// row groups of 16 a warp owns (one of them in the halo)
#ifndef FS2_MRF_STAGE_G16
#define FS2_MRF_STAGE_G16 4
#endif
#ifndef FS2_MRF_STAGE_G8
#define FS2_MRF_STAGE_G8 6
#endif

// The stage as the kernel walks it: conv pair p is conv 2p (dilation d[p])
// and conv 2p + 1 (dilation 1) of a resblock of kernel size k[p].
struct Stage {
  const bf16* w[2 * MAX_PAIRS];
  const void* b[2 * MAX_PAIRS];
  int k[MAX_PAIRS];
  int d[MAX_PAIRS];
  int flags[MAX_PAIRS];
  int n_pairs;
  float scale;  // 1 / resblocks
};

template <typename T, int C>
struct Tiling {
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int NL = SPLIT ? 2 : 1;  // bf16 parts of an operand
  static constexpr int NB = C / 8;          // n-blocks of 8 output channels
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int G = C == 16 ? FS2_MRF_STAGE_G16 : FS2_MRF_STAGE_G8;
  static constexpr int R = 16 * G * WARPS;  // tile rows computed
  static constexpr int BM = R - 2 * HALO;   // output rows a block
  static constexpr int TILE = R * C;        // elements of one part of P or Q
  // k-steps of 16 reduction rows in a conv of k taps, and the elements of
  // one part of its weight tile (at C 8 an odd k gets a zero tap)
  __host__ __device__ static constexpr int ksteps(int k) { return C == 16 ? k : (k + 1) / 2; }
  __host__ __device__ static constexpr int wtile(int k) { return ksteps(k) * 16 * C; }
  // P, Q and two weight buffers for convs of up to kmax taps
  static constexpr size_t smem(int kmax) {
    return (static_cast<size_t>(2 * NL * TILE) + 2 * NL * wtile(kmax)) * sizeof(bf16);
  }
  static_assert(G >= 2 && BM > 0, "each warp owns one halo group and at least one output group");
};

// element offset of 16-byte chunk c of row r in a tile (or a weight k-step)
// of C columns: at C 16 the chunks of a row swap in every other 4-row group
template <int C>
__device__ __forceinline__ int at(int r, int c) {
  if constexpr (C == 16)
    return r * 16 + ((c ^ ((r >> 2) & 1)) << 3);
  else
    return r * 8;
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : v * LRELU_SLOPE; }

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

// lrelu of two neighbouring values of row r (columns 8c + off, + 1) into a
// tile as bf16; for f32 x also their bf16-rounded remainder into the tile's
// low part, `lo` elements further
template <int C, bool SPLIT>
__device__ __forceinline__ void put(bf16* tile, int lo, int r, int c, int off, float v0,
                                    float v1) {
  const float a0 = lrelu(v0), a1 = lrelu(v1);
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const int i = at<C>(r, c) + off;
  *reinterpret_cast<__nv_bfloat162*>(tile + i) = h;
  if constexpr (SPLIT) {
    const float2 hf = __bfloat1622float2(h);
    *reinterpret_cast<uint32_t*>(tile + lo + i) = fs2::tc::pack_bf16(a0 - hf.x, a1 - hf.y);
  }
}

// B fragments of one k-step from a weight tile (rows = reduction, C
// columns), read transposed: at C 16 (b0, b1) of n-block 0 in f[0], f[1]
// and of n-block 1 in f[2], f[3]; at C 8 those of the one n-block in f[0],
// f[1]
template <int C>
__device__ __forceinline__ void load_b(uint32_t (&f)[4], const bf16* step, int lane) {
  if constexpr (C == 16) {
    const int m = lane >> 3, r = (m & 1) * 8 + (lane & 7);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
                 : "r"(fs2::tc::smem_u32(step + at<16>(r, m >> 1))));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(f[0]), "=r"(f[1])
                 : "r"(fs2::tc::smem_u32(step + (lane & 15) * 8)));
    f[2] = f[3] = 0u;
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// conv `c`'s weights (both parts) into a buffer, by cp.async: k * C rows of
// C bf16 a part, in the tile layout; rows past them (C 8, odd k) zero
template <int C, int NL, int NT>
__device__ __forceinline__ void load_weights(bf16* dst, const bf16* w, int k, int tid) {
  constexpr int CH = C / 8;
  const int rows = (C == 16 ? k : (k + 1) / 2) * 16, real = k * C;
  const int part = rows * C;
  for (int i = tid; i < NL * rows * CH; i += NT) {
    const int l = i / (rows * CH), j = i % (rows * CH), r = j / CH, c = j % CH;
    const bool ok = r < real;
    fs2::tc::cp_async16(dst + l * part + at<C>(r, c),
                        w + static_cast<long long>(l) * real * C + (ok ? r : 0) * C + c * 8, ok);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(Tiling<T, C>::THREADS, 2)
mrf_stage_kernel(const T* __restrict__ x, T* __restrict__ y, int T_len, int kmax,
                 const __grid_constant__ Stage st) {
  using Tile = Tiling<T, C>;
  constexpr bool SPLIT = Tile::SPLIT;
  constexpr int NL = Tile::NL, NB = Tile::NB, G = Tile::G, R = Tile::R, BM = Tile::BM;
  constexpr int TILE = Tile::TILE, NT = Tile::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* P = reinterpret_cast<bf16*>(smem_raw);  // lrelu(s): [NL][TILE]
  bf16* Q = P + NL * TILE;                      // lrelu(t): [NL][TILE]
  bf16* Wb = Q + NL * TILE;                     // two weight buffers
  const int wbuf = NL * Tile::wtile(kmax);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = blockIdx.x * BM;
  const long long b = blockIdx.y;
  const T* xb = x + b * T_len * C;
  T* yb = y + b * T_len * C;

  // this warp's row groups: group 0 in the halo (tile groups 0-3 and the
  // last 4), the others output rows
  int row0[G];
  row0[0] = 16 * (warp < 4 ? warp : 8 * G - 8 + warp);
#pragma unroll
  for (int q = 1; q < G; ++q) row0[q] = 16 * (4 + (G - 1) * warp + q - 1);
  // rows g and g + 8 of each group inside [0, T)
  bool in[G][2];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 - HALO + row0[q] + g + 8 * h;
      in[q][h] = t >= 0 && t < T_len;
    }

  float s[G][NB][4];        // the resblock state
  float out[G - 1][NB][4];  // the sum of the resblocks' outputs (output groups)
  float acc[G][NB][4];      // a conv's products
#pragma unroll
  for (int q = 0; q < G - 1; ++q)
#pragma unroll
    for (int n = 0; n < NB; ++n) out[q][n][0] = out[q][n][1] = out[q][n][2] = out[q][n][3] = 0.f;

  const int n_conv = 2 * st.n_pairs;
  load_weights<C, NL, NT>(Wb, st.w[0], st.k[0], tid);
  fs2::tc::cp_async_commit();

  for (int p = 0; p < st.n_pairs; ++p) {
    const int k = st.k[p], flags = st.flags[p];
    if (flags & FIRST) {  // s = x, P = lrelu(x); P's last reader (a conv 1) is behind a barrier
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0[q] + g + 8 * h;
          const long long t = t0 - HALO + r;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            float2 v = make_float2(0.f, 0.f);
            if (in[q][h]) v = load2(xb + t * C + 8 * n + 2 * t4);
            s[q][n][2 * h] = v.x;
            s[q][n][2 * h + 1] = v.y;
            put<C, SPLIT>(P, TILE, r, n, 2 * t4, v.x, v.y);
          }
        }
    }
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c = 2 * p + half;
      const int d = half == 0 ? st.d[p] : 1;
      fs2::tc::cp_async_wait<0>();  // this thread's copies of conv c's weights
      __syncthreads();  // everyone's copies; the tile this conv reads is written; the
                        // buffer and tile conv c - 1 read are free
      if (c + 1 < n_conv) load_weights<C, NL, NT>(Wb + ((c + 1) & 1) * wbuf, st.w[c + 1],
                                                  st.k[(c + 1) >> 1], tid);
      fs2::tc::cp_async_commit();

      const bf16* A = half == 0 ? P : Q;
      const bf16* W = Wb + (c & 1) * wbuf;
      const int wt = Tile::wtile(k);
      const int left = (k - 1) * d / 2;
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int n = 0; n < NB; ++n) acc[q][n][0] = acc[q][n][1] = acc[q][n][2] = acc[q][n][3] = 0.f;

      const int steps = Tile::ksteps(k);
#pragma unroll 1
      for (int kk = 0; kk < steps; ++kk) {
        uint32_t f[NL][4];
        load_b<C>(f[0], W + kk * 16 * C, lane);
        if constexpr (SPLIT) load_b<C>(f[1], W + wt + kk * 16 * C, lane);
        // this lane's fragment row, tap * d - left rows down (at C 8 lanes
        // 16-31 hold the k-step's second tap)
        const int shift = (C == 16 ? kk : 2 * kk + (lane >> 4)) * d - left + (lane & 15);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int r = min(max(row0[q] + shift, 0), R - 1);
          const bf16* a_at = A + (C == 16 ? at<16>(r, lane >> 4) : r * 8);
          uint32_t a[NL][4];
          fs2::tc::ldmatrix_x4(a[0], a_at);
          if constexpr (SPLIT) fs2::tc::ldmatrix_x4(a[1], a_at + TILE);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            mma(acc[q][n], a[0], f[0][2 * n], f[0][2 * n + 1]);
            if constexpr (SPLIT) {
              mma(acc[q][n], a[1], f[0][2 * n], f[0][2 * n + 1]);
              mma(acc[q][n], a[0], f[1][2 * n], f[1][2 * n + 1]);
            }
          }
        }
      }

      // epilogue: bias, rows outside [0, T) to zero, then t into Q, or
      // s += into P (the resblock's last conv: into the sum instead)
      const T* bias = static_cast<const T*>(st.b[c]);
      float2 bv[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) bv[n] = load2(bias + 8 * n + 2 * t4);
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0[q] + g + 8 * h;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float v0 = in[q][h] ? acc[q][n][2 * h] + bv[n].x : 0.f;
            const float v1 = in[q][h] ? acc[q][n][2 * h + 1] + bv[n].y : 0.f;
            if (half == 0) {
              put<C, SPLIT>(Q, TILE, r, n, 2 * t4, v0, v1);
            } else {
              const float s0 = s[q][n][2 * h] + v0, s1 = s[q][n][2 * h + 1] + v1;
              s[q][n][2 * h] = s0;
              s[q][n][2 * h + 1] = s1;
              if (!(flags & LAST)) {
                put<C, SPLIT>(P, TILE, r, n, 2 * t4, s0, s1);
              } else if (q > 0) {
                out[q - 1][n][2 * h] += s0;
                out[q - 1][n][2 * h + 1] += s1;
              }
            }
          }
        }
    }
  }

  // y: the output groups' mean over the resblocks, rows inside [0, T)
#pragma unroll
  for (int q = 1; q < G; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!in[q][h]) continue;
      const long long t = t0 - HALO + row0[q] + g + 8 * h;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        store2(yb + t * C + 8 * n + 2 * t4, out[q - 1][n][2 * h] * st.scale,
               out[q - 1][n][2 * h + 1] * st.scale);
    }
}

template <typename T, int C>
cudaError_t launch(const void* x, void* y, int B, int T_len, int kmax, const Stage& st,
                   cudaStream_t stream) {
  using Tile = Tiling<T, C>;
  // the opt-in covers the widest conv a stage may have; a launch asks for
  // what its own widest conv needs
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(opt_in, mrf_stage_kernel<T, C>,
                                            static_cast<int>(Tile::smem(MAX_K)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + Tile::BM - 1) / Tile::BM, B);
  mrf_stage_kernel<T, C><<<grid, Tile::THREADS, Tile::smem(kmax), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), T_len, kmax, st);
  return cudaGetLastError();
}

// the larger of a conv's two SAME extents, (k - 1) * d / 2 before and the
// rest after
int extent(int k, int d) {
  const int span = (k - 1) * d;
  return span - span / 2 > span / 2 ? span - span / 2 : span / 2;
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// One stage of `n_blocks` resblocks: resblock j has kernel size ks[j] and
// n_dils[j] dilations, the next n_dils[j] of `dils`; `w` and `bias` hold
// the 2 * (pairs) convs' weight and bias pointers in the order
// prepare_stage_weights gives them (for each resblock, for each dilation:
// conv 1, conv 2). dtype 0: f32 x, y and biases, weights bf16 [2, k, C, C];
// 1: bf16, weights [k, C, C]. Returns a cudaError_t code (0 on success).
extern "C" int mrf_stage(int dtype, const void* x, void* y, const void* const* w,
                         const void* const* bias, const int* ks, const int* n_dils,
                         const int* dils, int n_blocks, int B, int T_len, int C,
                         void* stream) {
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || T_len <= 0 || n_blocks <= 0 || x == y)
    return static_cast<int>(cudaErrorInvalidValue);
  Stage st{};
  int p = 0, kmax = 1;
  for (int j = 0; j < n_blocks; ++j) {
    const int k = ks[j];
    if (k < 1 || k > MAX_K || n_dils[j] < 1 || p + n_dils[j] > MAX_PAIRS)
      return static_cast<int>(cudaErrorInvalidValue);
    int reach = 0;
    for (int i = 0; i < n_dils[j]; ++i, ++p) {
      const int d = dils[p];
      if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
      reach += extent(k, d) + extent(k, 1);
      st.k[p] = k;
      st.d[p] = d;
      st.flags[p] = (i == 0 ? FIRST : 0) | (i == n_dils[j] - 1 ? LAST : 0);
      for (int h = 0; h < 2; ++h) {
        st.w[2 * p + h] = static_cast<const bf16*>(w[2 * p + h]);
        st.b[2 * p + h] = bias[2 * p + h];
      }
    }
    if (reach > HALO) return static_cast<int>(cudaErrorInvalidValue);
    kmax = k > kmax ? k : kmax;
  }
  st.n_pairs = p;
  st.scale = 1.0f / n_blocks;
#define FS2_MRF_STAGE(TT, CC) \
  if (C == CC) return static_cast<int>(launch<TT, CC>(x, y, B, T_len, kmax, st, sm));
  if (dtype == fs2::kFloat32) {
    FS2_MRF_STAGE(float, 8)
    FS2_MRF_STAGE(float, 16)
  } else if (dtype == fs2::kBFloat16) {
    FS2_MRF_STAGE(bf16, 8)
    FS2_MRF_STAGE(bf16, 16)
  }
#undef FS2_MRF_STAGE
  return static_cast<int>(cudaErrorInvalidValue);
}
