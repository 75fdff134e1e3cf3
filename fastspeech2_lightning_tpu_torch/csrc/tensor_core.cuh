// Tensor-core building blocks of the bf16 attention kernels
// (attention_fwd.cu, attention_bwd.cu): 16-byte cp.async copies into
// 128-byte-swizzled shared-memory tiles, their wgmma matrix descriptors, and
// the sm_90a warpgroup product wgmma (bf16 in, f32 accumulators) with one
// operand from registers or both from shared memory.
//
// Register fragments of a warpgroup product m64nNk16 (warp w of the
// warpgroup holds rows 16w..16w+15; lane = 4 * g + t):
//   accumulator, n-block j (columns 8j..8j+7), d[j][0..3]:
//       (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1)
//   A from registers, one k-step (16 columns), a[0..3] (bf16 pairs):
//       (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
// The kernels find the (row, column) of every accumulator from this, e.g. for
// the dropout hash; and the accumulators of n-blocks 2kk and 2kk + 1, packed
// to bf16 pairs, are the A fragment of k-step kk (how P and dS feed the next
// product from registers).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fs2 {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (`src`
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (ex2.approx, 2 ulp; results below 2^-126
// flush to 0, which softmax weights of that size are in f32 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from the accumulators of n-blocks 2kk, 2kk + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// -- tiles in shared memory --------------------------------------------------
//
// A tile of R rows x DH bf16 is stored as DH / 64 column blocks of R rows x
// 64 bf16 (128 bytes a row), each 16-byte chunk c of row r at chunk
// c ^ (r % 8): the 128-byte swizzle the descriptors below name. Every tile
// starts on 1024 bytes (the swizzle's period).

template <int R>
__device__ __forceinline__ int sw128(int row, int chunk) {
  return (chunk >> 3) * R * 64 + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// R rows x DH bf16 from rows row0.. of a strided [T, DH] matrix (row stride
// `st` elements, 16-byte aligned rows) into a tile; rows at or past T_len
// are zero-filled. NT threads, each copying R * DH / 8 / NT chunks.
template <int R, int DH, int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g, long long st, int row0,
                                          int T_len, int tid) {
  constexpr int CH = DH / 8;
  static_assert((R * CH) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < R * CH / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / CH, c = i % CH, t = row0 + r;
    const bool ok = t < T_len;
    cp_async16(tile + sw128<R>(r, c), g + static_cast<long long>(ok ? t : 0) * st + c * 8, ok);
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units). K-major operands (rows = M or
// N, K contiguous): the stride offset is 1024 (8 rows of 128 bytes), the
// leading offset unused; a k-step of 16 advances the start by 32 bytes
// within a 64-wide column block, and by R * 128 bytes to the next block.
// MN-major operands (rows = K, M or N contiguous), read with the transpose
// flag: stride offset 1024 (8 K-rows), leading offset R * 128 (the next
// 64-wide block of M or N); a k-step advances the start by 16 rows.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* start, uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return static_cast<uint64_t>((smem_u32(start) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride_bytes >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// make this thread's generic-proxy writes to shared memory (cp.async, st)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// order register writes (accumulators, A fragments) before the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// -- warpgroup products -------------------------------------------------------

// d[32] += A(smem desc) * B(smem desc), m64n64k16; TA, TB = 1 read A, B
// transposed (stored MN-major), 0 as stored (K-major)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d[32] += A(registers) * B(smem desc), m64n64k16, B read transposed
// (stored MN-major: rows = K, N contiguous)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A(registers) * B(smem desc), m64n128k16, B read transposed
// (stored MN-major: rows = K, N contiguous)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


}  // namespace tc
}  // namespace fs2
