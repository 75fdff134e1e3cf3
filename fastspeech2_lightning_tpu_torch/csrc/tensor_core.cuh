// Tensor-core building blocks of the attention kernels (attention_fwd.cu,
// attention_bwd.cu) and the MRF conv kernel (mrf_conv.cu): 16-byte cp.async
// copies into swizzled shared-memory tiles, their wgmma matrix descriptors,
// ldmatrix for A fragments, and the sm_90a warpgroup product wgmma (bf16 in,
// f32 accumulators) with one operand from registers or both from shared
// memory; for a product 16 columns wide, one warp's mma.sync.
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

// A 64-byte-swizzled tile of R rows x 32 bf16 (64 bytes a row): 16-byte chunk
// c of row r at chunk c ^ ((r / 2) % 4); the period is 8 rows (512 bytes),
// on which every such tile starts.
__device__ __forceinline__ int sw64(int row, int chunk) {
  return row * 32 + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// Its descriptor for an MN-major operand 32 wide (rows = K, N contiguous),
// read with the transpose flag: stride offset 512 (8 K-rows), the leading
// offset unused (one swizzle row holds all of N); a k-step advances the
// start by 16 rows.
__device__ __forceinline__ uint64_t sw64_desc(const bf16* start) {
  return static_cast<uint64_t>((smem_u32(start) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// The A fragment of one k-step for 16 rows of a row-major bf16 matrix in
// shared memory: four 8 x 8 blocks (rows 0-7 and 8-15, columns 0-7 and
// 8-15), a[0..3] in the order the header names. `p` is this lane's row
// address: row (lane % 16), column 8 * (lane / 16) of the 16 x 16 block,
// 16-byte aligned.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// make this thread's generic-proxy writes to shared memory (cp.async, st)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- mbarriers, named barriers and the tensor memory accelerator (TMA) ---------
//
// A tile that a kernel loads with TMA lands in the 128-byte-swizzled layout
// above: each copy is one box of 64 bf16 columns (128 bytes) by R rows of a
// tensor map made with CU_TENSOR_MAP_SWIZZLE_128B, written to a 1024-byte
// aligned address, with rows past the tensor's end zero-filled. Its
// completion is counted in bytes on an mbarrier (complete_tx), so a
// consumer that waits on that barrier may read the tile with wgmma at once:
// both the copy and wgmma are in the async proxy.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the barriers are initialised, before any other thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more for the barrier's phase to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// a box of the 4-D tensor map `map` at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; its bytes complete on `bar`. `map` is a
// __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// hardware barrier `id` (1-15; 0 is __syncthreads') over `n` threads: wait
// for them, or count this warp's threads in and go on
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
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

// d[16] += A(smem desc) * B(smem desc), m64n32k16; TA, TB as wgmma_ss_n64.
// A K-major B of 32 rows may start at any 8th row of a tile; an MN-major B
// may be either half of a 64-wide column block (start + 0 or + 32 columns).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d[64] += A(smem desc) * B(smem desc), m64n128k16; TA, TB as wgmma_ss_n64
// (an MN-major B spans two 64-wide column blocks, the descriptor's leading
// offset apart)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d[16] += A(registers) * B(smem desc), m64n32k16, B read transposed
// (stored MN-major: rows = K, N contiguous)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// d[N / 8][4] += A(registers) * B for one k-step, B the N columns of a
// 128-byte-swizzled MN-major tile of R rows (its 64-wide column blocks R * 64
// elements apart) from the k-step's first row `b`: one m64n128 product per
// 128 columns where N is a multiple of 128, else one m64n64 per 64 columns
// (N = 64 and 192). Each product's accumulators are a slice of d.
template <int N, int R>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                              const bf16* b) {
  static_assert(N % 64 == 0, "whole 64-wide column blocks");
  if constexpr (N % 128 == 0) {
#pragma unroll
    for (int c = 0; c < N / 128; ++c)
      wgmma_rs_n128(*reinterpret_cast<float(*)[16][4]>(&d[16 * c]), a,
                    sw128_desc(b + 2 * c * R * 64, R * 128, 1024));
  } else {
#pragma unroll
    for (int c = 0; c < N / 64; ++c)
      wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&d[8 * c]), a,
                   sw128_desc(b + c * R * 64, R * 128, 1024));
  }
}

// As wgmma_rs_cols, with A the K-major shared-memory descriptor `a` (N a
// multiple of 64: one m64n128 product per 128 columns, and an m64n64 for the
// last 64 where N is an odd multiple of 64).
template <int N, int R>
__device__ __forceinline__ void wgmma_ss_cols(float (&d)[N / 8][4], uint64_t a, const bf16* b) {
  static_assert(N % 64 == 0, "whole 64-wide column blocks");
#pragma unroll
  for (int c = 0; c < N / 128; ++c)
    wgmma_ss_n128<0, 1>(*reinterpret_cast<float(*)[16][4]>(&d[16 * c]), a,
                        sw128_desc(b + 2 * c * R * 64, R * 128, 1024));
  if constexpr (N % 128 != 0)
    wgmma_ss_n64<0, 1>(*reinterpret_cast<float(*)[8][4]>(&d[N / 8 - 8]), a,
                       sw128_desc(b + (N / 64 - 1) * R * 64, R * 128, 1024));
}

// d[2][4] += A(registers) * B, one warp's m16n8k16 products (mma.sync) for
// its 16 rows and 16 columns, B from a row-major [16][16] bf16 block in
// shared memory (row stride `ld` elements, rows 16-byte aligned) read
// transposed by ldmatrix. The accumulator and A layouts are a warpgroup
// product's for this warp (the header), so a kernel can take either.
__device__ __forceinline__ void mma_rs_n16(float (&d)[2][4], const uint32_t (&a)[4],
                                           const bf16* b, int ld, int lane) {
  // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15):
  // the B fragments (b0, b1) of n-block 0, then of n-block 1
  const int m = lane >> 3;
  const bf16* p = b + ((m & 1) * 8 + (lane & 7)) * ld + (m >> 1) * 8;
  uint32_t f[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(smem_u32(p)));
#pragma unroll
  for (int n = 0; n < 2; ++n)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(f[2 * n]), "r"(f[2 * n + 1]));
}

}  // namespace tc
}  // namespace fs2
