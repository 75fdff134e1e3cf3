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
// bits [B, ceil(L/32), T] uint32.
//
// Replaces fastspeech2_lightning_tpu/ops/mas_pallas.py:94 mas_width1_pallas
// (_mas_kernel :34), with the semantics of ops/mas.py:93-147. Adds and maxes
// in one fixed order are exact in f32, so the path equals the plain version's
// (ops/mas.py mas_width1_reference) bit for bit.
//
// Bound: read B*T*L*4 bytes and write B*T*L*4 bytes (plus B*L*4); at B=16,
// T=2048, L=1000 that is 262 MB, about 78 us at 3.35 TB/s: memory-bound.
//
// Design. What sets this kernel's time is latency, not bytes: out_len
// dependent steps forward and out_len dependent steps back, one block per
// batch item. So each step is made short.
//  - The outputs are zeroed by cudaMemsetAsync on the same stream, at the
//    card's bandwidth; the kernel writes only the ones and the counts.
//  - Forward: only the rows below out_len, only the warps that cover in_len.
//    A lane of a search warp holds one, two or four columns (for L up to
//    256, 512, and past 512), 32 apart (so a ballot over the warp is one
//    word of 32 neighbouring columns), and keeps their P[i-1, j] in
//    registers: at most eight warps step a row in a block. The left
//    neighbour comes by shuffle.
//  - No barrier a row. A warp also carries the 32 columns left of its own
//    (a halo, recomputed with the same adds and maxes, so bit-equal where
//    valid). A halo column stays valid one row less for every column it
//    lies further left, so the halo serves 32 rows; every 16 rows the warps
//    meet at one named barrier and take the halo afresh from their
//    neighbour's registers through shared memory.
//  - The log_attn rows arrive in blocks of 16 rows through a ring of three
//    blocks in shared memory, filled by four copy warps with cp.async a block
//    or more ahead and handed over at the same barrier, so the search warps'
//    loop holds no address arithmetic and no wait on device memory. Rows
//    that start on 16 bytes (L % 4 == 0) are copied four columns a cp.async.
//    What bounds a step now is the row's own chain: shuffle, select, max,
//    add, max, at one search warp a scheduler. Tried on the way (PERF.md):
//    loads kept in registers 8 or 16 rows ahead, one column a thread and a
//    barrier a row, took as long as no prefetch; each lane copying its own
//    columns with 4-byte cp.async took half of a step; reading the ring one
//    row ahead into registers made it slower.
//  - A warp's 32 move decisions of a row are one ballot word (T*L/8 bytes
//    per item: the DP table never reaches device memory), and the words of
//    32 rows leave in one store.
//  - Texts past the ring's reach (L > 1024): a cluster of blocks an item,
//    each the ring kernel at L 1024 on its own slice of 1024 columns, the
//    halo across a block boundary handed over through distributed shared
//    memory; past 8192 columns, panels of eight such blocks launched one
//    after the other, the halo across a panel boundary through device
//    memory (mas_width1_cluster_kernel, at the end of this file, with its
//    measured times).
//  - Backtrack: warp 0 takes 32 rows at a time. From column c the path falls
//    by at most one a row, so the 32 rows' decisions all lie in columns
//    c - 31 .. c: two words a row, loaded by the 32 lanes together and
//    shifted into one 32-bit window each (ops/mas.py backtrack_window is the
//    same arithmetic). The lanes then walk the 32 rows in registers, one
//    shuffle a row, write their 32 ones together, and add each run of equal
//    columns to the durations as one count.

#include <math.h>

#include "cluster.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e9f;
// The ring kernel's reach, and whether the cluster kernel's copy warps
// stage the rows: macros so that tools/cluster_chain_variants.py can build
// the source with the cluster kernel from L 513 (one block a cluster) and
// without its copies (a timing only: the path is then wrong).
#ifndef FS2T_MAS_RING_L
#define FS2T_MAS_RING_L 1024
#endif
#ifndef FS2T_MAS_STAGE
#define FS2T_MAS_STAGE 1
#endif
constexpr int RING_L = FS2T_MAS_RING_L;
constexpr int MAX_WARPS = 8;              // search warps, each over 32 * COLS columns
constexpr int COPY_WARPS = 4;
constexpr int BLOCK = 16;                 // rows between two barriers; at most the halo's 32
constexpr int SLOTS = 3;                  // row blocks in the shared-memory ring
constexpr unsigned FULL = 0xffffffffu;

// barrier `id` over n threads of the block (n a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Warp 0's backtrack from (n - 1, in_len - 1) over the decision words
// bits_b [ceil(L / 32)][T] of item b: the ones of hard and the durations.
__device__ __forceinline__ void backtrack(float* __restrict__ hard, int* __restrict__ durations,
                                          const uint32_t* bits_b, int b, int T, int L,
                                          int in_len, int n, int lane) {
  float* hard_b = hard + static_cast<long long>(b) * T * L;
  int* dur_b = durations + static_cast<long long>(b) * L;
  int c = in_len - 1;  // the path's column at row `top`
  for (int top = n - 1; top >= 0; top -= 32) {
    const int i = top - lane;  // this lane's row
    uint32_t w_hi = 0u, w_lo = 0u;
    if (i >= 1) {  // row 0 decides nothing
      const uint32_t* word = bits_b + static_cast<long long>(c >> 5) * T + i;
      w_hi = word[0];
      if (c >= 32) w_lo = word[-T];
    }
    // bit p of the window: the decision at column c - 31 + p
    const uint32_t window = static_cast<uint32_t>(
        ((static_cast<uint64_t>(w_hi) << 32) | w_lo) >> ((c & 31) + 1));
    int p = 31, my_c = c;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const uint32_t wl = __shfl_sync(FULL, window, l);
      if (lane == l) my_c = c;
      const int mv = (wl >> p) & 1;
      c -= mv;
      p -= mv;
    }
    const bool on = i >= 0;
    if (on) hard_b[static_cast<long long>(i) * L + my_c] = 1.f;
    // durations: each run of equal columns among these rows adds its length
    const uint32_t rows = __ballot_sync(FULL, on);
    const int above = __shfl_up_sync(FULL, my_c, 1);
    const bool start = on && (lane == 0 || above != my_c);
    const uint32_t starts = __ballot_sync(FULL, start);
    if (start) {
      const uint32_t later = starts & ~((2u << lane) - 1u);
      const int end = later ? __ffs(later) - 1 : __popc(rows);
      atomicAdd(dur_b + my_c, end - lane);
    }
  }
}

// One row i of the search for this lane: the move decisions of its owned
// columns (lane i % 32 keeps row i's ballot words), the new P[i, j] in cur,
// and the words of 32 rows out to bits_b after every 32nd row and the last
// (n - 1), as words word0 + k of the item's. la(g): row i's log-attention at
// the lane's halo column (g = 0, read only with `halo`) or at owned column
// g - 1.
template <int COLS, typename Row>
__device__ __forceinline__ void mas_row(float (&cur)[COLS + 1], uint32_t (&keep)[COLS],
                                        const Row& la, int i, int n, bool halo, int word0,
                                        int lane, int n_groups, uint32_t* bits_b, int T) {
  // the left neighbour: the lane before, for lane 0 lane 31 of the 32
  // columns before. Left of column 0 (warp 0's cur[0]) and of the halo's
  // first column (not valid past a block's first row anyway) is -inf:
  // below every P, so no move and the same max.
  float rot[COLS + 1], left[COLS + 1];
#pragma unroll
  for (int g = 0; g <= COLS; ++g) rot[g] = __shfl_sync(FULL, cur[g], (lane + 31) & 31);
  left[0] = lane == 0 ? -INFINITY : rot[0];
#pragma unroll
  for (int g = 1; g <= COLS; ++g) left[g] = lane == 0 ? rot[g - 1] : rot[g];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const uint32_t word = __ballot_sync(FULL, left[1 + k] >= cur[1 + k]);
    if (lane == (i & 31)) keep[k] = word;
  }
  if (halo) cur[0] = fmaxf(fmaxf(la(0), NEG_INF) + fmaxf(cur[0], left[0]), NEG_INF);
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    cur[1 + k] = fmaxf(fmaxf(la(1 + k), NEG_INF) + fmaxf(cur[1 + k], left[1 + k]), NEG_INF);
  if ((i & 31) == 31 || i == n - 1) {  // 32 rows' words in one store a column group
    const int r = (i & ~31) + lane;
#pragma unroll
    for (int k = 0; k < COLS; ++k)
      if (r <= i && k < n_groups)
        bits_b[static_cast<long long>(word0 + k) * T + r] = keep[k];
  }
}

// COLS: column groups a lane owns, 32 k + lane of its warp's 32 * COLS
// columns. Fewer for shorter texts: the same eight warps at most, and fewer
// instructions a row for each.
template <int COLS>
__global__ void __launch_bounds__((MAX_WARPS + COPY_WARPS) * 32)
mas_width1_kernel(const float* __restrict__ log_attn, const int* __restrict__ in_lens,
                  const int* __restrict__ out_lens, float* __restrict__ hard,
                  int* __restrict__ durations, uint32_t* bits, int T, int L) {
  extern __shared__ float ring[];              // [SLOTS * BLOCK][row_floats]
  __shared__ float halo[2][MAX_WARPS][32];     // each warp's last 32 columns, by block parity
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int in_len = in_lens[b];
  const int n = min(out_lens[b], T);  // rows on the path
  // as in the JAX package, lengths outside [1, L] leave the item all zero
  if (n <= 0 || in_len <= 0 || in_len > L) return;
  const int n_warps = (in_len + 32 * COLS - 1) / (32 * COLS);  // search warps at work
  const int first_copy_warp = (blockDim.x >> 5) - COPY_WARPS;
  const int row_floats = first_copy_warp * 32 * COLS;
  const int n_meet = (n_warps + COPY_WARPS) * 32;  // threads at a block's barrier
  const float* la_b = log_attn + static_cast<long long>(b) * T * L;

  if (warp >= first_copy_warp) {
    // copy warps: the rows of block m, columns 0 .. 128 n_warps - 1 (zero
    // past L), into ring rows (row % 48); one cp.async group a block. Rows
    // that start on 16 bytes (L % 4 == 0) go four columns a copy.
    const int c = (warp - first_copy_warp) * 32 + lane;  // of 128 copy lanes
    const int n_blocks = (n + BLOCK - 1) / BLOCK;
    const int width = n_warps * 32 * COLS;
    const bool wide = (L & 3) == 0 && (reinterpret_cast<uintptr_t>(log_attn) & 15) == 0;
    auto copy_block = [&](int m) {
      if (m < n_blocks) {
        const int last = min(n, (m + 1) * BLOCK);
        float* dst = ring + (m % SLOTS) * BLOCK * row_floats;
        const float* src = la_b + static_cast<long long>(m) * BLOCK * L;
        for (int i = m * BLOCK; i < last; ++i, dst += row_floats, src += L) {
          if (wide) {
            for (int j = 4 * c; j < width; j += 4 * 32 * COPY_WARPS)
              fs2::tc::cp_async16(dst + j, j < L ? src + j : la_b, j < L);
          } else {
            for (int j = c; j < width; j += 32 * COPY_WARPS)
              fs2::tc::cp_async4(dst + j, j < L ? src + j : la_b, j < L);
          }
        }
      }
      fs2::tc::cp_async_commit();
    };
    copy_block(0);
    copy_block(1);
    for (int m = 0; m < n_blocks; ++m) {
      // block m + 1 goes where block m - 2 was: the search warps left it
      // before the barrier that handed them block m - 1
      if (m > 0) copy_block(m + 1);
      fs2::tc::cp_async_wait<1>();  // block m has landed
      bar_sync(1, n_meet);          // and is handed over
    }
    return;
  }
  if (warp >= n_warps) return;

  const int jw = warp * 32 * COLS + lane;  // this lane's columns: jw + 32 k, and jw - 32 (halo)
  const int n_groups = min(COLS, (in_len - warp * 32 * COLS + 31) >> 5);  // with a live column
  uint32_t* bits_b = bits + static_cast<long long>(b) * ((L + 31) / 32) * T;
  // P[i - 1, j]: cur[0] of the halo column (-inf for warp 0, which has
  // none), cur[1 + k] of owned column k
  float cur[COLS + 1];
  uint32_t keep[COLS] = {};  // lane r: the decision words of row (i & ~31) + r
  for (int i0 = 0; i0 < n; i0 += BLOCK) {
    const int block = i0 / BLOCK;
    const float* row = ring + (block % SLOTS) * BLOCK * row_floats + jw;
    if (i0 == 0) {
      bar_sync(1, n_meet);
      cur[0] = warp > 0 ? fmaxf(row[-32], NEG_INF) + NEG_INF : -INFINITY;
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        cur[1 + k] = fmaxf(row[32 * k], NEG_INF) + (jw + 32 * k == 0 ? 0.f : NEG_INF);
    } else {  // meet, and take the halo afresh
      halo[block & 1][warp][lane] = cur[COLS];
      bar_sync(1, n_meet);
      if (warp > 0) cur[0] = halo[block & 1][warp - 1][lane];
    }
    const int last = min(n, i0 + BLOCK);
#pragma unroll 4
    for (int i = max(i0, 1); i < last; ++i) {
      const float* x = row + (i - i0) * row_floats;
      mas_row<COLS>(cur, keep, [&](int g) { return g == 0 ? x[-32] : x[32 * (g - 1)]; }, i, n,
                    warp > 0, warp * COLS, lane, n_groups, bits_b, T);
    }
  }
  // every warp's decision words are visible to warp 0
  if (n_warps > 1) bar_sync(2, n_warps * 32);
  __syncwarp();
  if (warp != 0) return;
  backtrack(hard, durations, bits_b, b, T, L, in_len, n, lane);
}

template <int COLS>
cudaError_t launch(const void* log_attn, const void* in_lens, const void* out_lens, void* hard,
                   void* durations, void* bits, int B, int T, int L, cudaStream_t stream) {
  const int search_warps = (L + 32 * COLS - 1) / (32 * COLS);
  const size_t smem = sizeof(float) * SLOTS * BLOCK * search_warps * 32 * COLS;
  // the opt-in belongs to the kernel in the current device's context, so it
  // is kept per device: one process may launch on several cards
  static fs2::SmemOptIn opt_in;
  const cudaError_t attr = fs2::smem_opt_in(
      opt_in, mas_width1_kernel<COLS>,
      static_cast<int>(sizeof(float) * SLOTS * BLOCK * MAX_WARPS * 32 * COLS));
  if (attr != cudaSuccess) return attr;
  mas_width1_kernel<COLS><<<B, (search_warps + COPY_WARPS) * 32, smem, stream>>>(
      static_cast<const float*>(log_attn), static_cast<const int*>(in_lens),
      static_cast<const int*>(out_lens), static_cast<float*>(hard),
      static_cast<int*>(durations), static_cast<uint32_t*>(bits), T, L);
  return cudaGetLastError();
}

// -- texts past the ring's reach: a cluster of blocks an item ------------------
//
// Past L 1024 a block of 16 rows is 64 KB or more, and a ring of three over
// the whole row would not fit one block's shared memory. So an item's
// columns are cut into slices of SLICE_L (1024, the ring kernel's widest),
// one block of a thread-block cluster each (ceil(L / 1024) blocks: 2 at L
// 2000, 8 at 8192). Each block is the ring kernel at L 1024 on its slice:
// eight search warps of four column groups, four copy warps staging its
// columns (and the 32 left of them) of 16 rows at a time into its own ring
// of three, the warps meeting at a named barrier every 16 rows. Warp 0 of a
// block right of the first carries the 32 columns left of its slice as its
// halo, as every other warp does, and takes them afresh at each meet from
// the last warp of the block on its left. A courier warp in each block
// carries them: after a meet it stores the last search warp's 32 columns
// into the next block's shared memory (st.shared::cluster) and arrives on
// an mbarrier there; before a meet it waits on its own block's mbarrier
// and puts what arrived where warp 0 reads it after the meet. Nothing flows
// leftwards, so a hand-over is a wait on that mbarrier, not a barrier of
// the cluster, and no search warp waits on the cluster: the block on the
// left runs ahead by up to EDGE_SLOTS hand-overs, and the one on its right
// pays the hand-over's latency once, not at each meet. A block whose slice
// starts past in_len has nothing to do and gets nothing. Every block's
// decision words go to `bits`; after one cluster barrier (release and
// acquire at cluster scope: the words are ordered before the backtrack
// reads them, and no block leaves while a neighbour may still touch its
// shared memory) warp 0 of the first block runs the backtrack. The row
// arithmetic is mas_row's, so the path is the ring kernel's, bit for bit.
//
// Past PANEL_L (8192) columns a cluster would need more than the eight
// blocks a portable cluster holds, so the columns are cut into panels of
// at most PANEL_L, launched in turn on one stream, each a launch of this
// kernel over its panel's blocks (block0: the panel's first block in the
// item). A panel's last block, where the next panel has a live column,
// writes what its courier would hand on, the last 32 columns at each meet,
// to `edge_out` ([B][ceil(T / 16)][32] f32, one row a hand-over) instead,
// and the next panel's first block takes them from there (`edge_in`): the
// previous launch has ended, so every value is in device memory and no
// wait is needed. The columns, their halo and their arithmetic are those
// of one cluster of all the item's blocks, so the path is still bit for
// bit the ring kernel's. Only the last panel's launch runs the backtrack,
// over the decision words every panel wrote. Measured (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py phase 33, tools/panel_timing.py): at (4, 16384,
// 16384), two panels of one wave of four clusters each, 7.48 ms of device
// time against a bound of 2.01 (bytes), 228 ns a row and panel.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, tools/default_shapes_ab.py):
// at (16, 2048, 2000) 0.499 ms of device time, 244 ns a row (the ring
// kernel at L 1000: 197), against 1.135 for the direct kernel it replaced;
// at L 4096 0.586 (1.384); at L 8191 1.155 (2.037), two waves: the card
// holds 15 clusters of 8 such blocks at once. What sets a block's row is
// its copy warps: at L 1000 one block a cluster took 221 ns a row, 178
// with the copies taken out (tools/cluster_chain_variants.py). Alternatives
// set aside:
//  - the direct kernel this one replaced (16 warps, each lane's columns
//    read from device memory a row ahead, no ring): a device-memory round
//    trip a row;
//  - a barrier of the cluster at every meet: a hand-over runs one way, so
//    an mbarrier in the receiving block does;
//  - the hand-over carried by a search warp or a copy warp: a release at
//    cluster scope waits for the thread's memory operations, a copy warp's
//    cp.async in flight among them, so it has a warp of its own;
//  - the cluster scheduling policies Spread and LoadBalancing: 0.500 and
//    0.500 against 0.500 (tools/cluster_chain_variants.py).
constexpr int SLICE_L = 1024;           // columns a block owns: MAX_WARPS warps of 4 groups
constexpr int PANEL_BLOCKS = 8;         // blocks a cluster at most (portable clusters)
constexpr int PANEL_L = PANEL_BLOCKS * SLICE_L;  // columns a launch at most
constexpr int SLICE_COLS = 4;
constexpr int EDGE = 32;                // halo columns a block takes from its left neighbour
constexpr int EDGE_SLOTS = 4;           // hand-overs in flight between two neighbours
constexpr int SLICE_ROW = EDGE + SLICE_L;  // a ring row: the halo's columns, then the slice's
constexpr int COURIER = MAX_WARPS + COPY_WARPS;  // the warp that carries the halo across blocks
constexpr int CLUSTER_THREADS = (COURIER + 1) * 32;
constexpr size_t CLUSTER_SMEM = sizeof(float) * SLOTS * BLOCK * SLICE_ROW;
// copies a copy lane makes of a ring row: four columns each (rows on 16
// bytes), or one
constexpr int WIDE_CHUNKS = (SLICE_ROW + 4 * 32 * COPY_WARPS - 1) / (4 * 32 * COPY_WARPS);
constexpr int NARROW_CHUNKS = (SLICE_ROW + 32 * COPY_WARPS - 1) / (32 * COPY_WARPS);
fs2::SmemOptIn cluster_opt_in;  // the launch's and the layout query's, per device
fs2::cluster::Occupancy cluster_occupancy;

__global__ void __launch_bounds__(CLUSTER_THREADS)
mas_width1_cluster_kernel(const float* __restrict__ log_attn, const int* __restrict__ in_lens,
                          const int* __restrict__ out_lens, float* __restrict__ hard,
                          int* __restrict__ durations, uint32_t* bits,
                          const float* __restrict__ edge_in_g, float* __restrict__ edge_out_g,
                          int T, int L, int block0, int backtracks) {
  constexpr int COLS = SLICE_COLS;
  extern __shared__ float ring[];            // [SLOTS * BLOCK][SLICE_ROW]
  __shared__ float halo[2][MAX_WARPS][32];   // each warp's last 32 columns, by block parity
  __shared__ float edge[EDGE_SLOTS][32];     // the left block's last 32 columns, handed over
  __shared__ float edge_in[2][32];           // the same, for warp 0, by block parity
  __shared__ uint64_t full[EDGE_SLOTS], empty[EDGE_SLOTS];
  const int rank = fs2::cluster::rank(), size = fs2::cluster::size();
  const int grank = block0 + rank;  // this block's slice of the item
  const int b = blockIdx.x / size;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int in_len = in_lens[b];
  const int n = min(out_lens[b], T);  // rows on the path
  // lengths outside [1, L] leave the item all zero: every block of the
  // cluster returns here alike, before any cluster barrier
  if (n <= 0 || in_len <= 0 || in_len > L) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EDGE_SLOTS; ++s) {
      fs2::tc::mbar_init(&full[s], 32);
      fs2::tc::mbar_init(&empty[s], 32);
    }
    fs2::tc::mbar_init_fence();
  }
  fs2::cluster::sync();  // every block's mbarriers are set before any arrives on them
  const int c0 = grank * SLICE_L;  // this block's first column
  const int n_warps =
      in_len > c0 ? min(MAX_WARPS, (in_len - c0 + 32 * COLS - 1) / (32 * COLS)) : 0;
  const bool feeds = in_len > c0 + SLICE_L;  // the next block has a live column (and all 8 here)
  uint32_t* bits_b = bits + static_cast<long long>(b) * ((L + 31) / 32) * T;
  if (n_warps > 0) {
    const int n_meet = (n_warps + COPY_WARPS + 1) * 32;  // threads at a block's barrier
    const int n_blocks = (n + BLOCK - 1) / BLOCK;         // meets, the first included
    // hand-overs across a panel boundary: row m - 1 of item b's at meet m
    const long long edge_row0 = static_cast<long long>(b) * ((T + BLOCK - 1) / BLOCK) - 1;
    const float* la_b = log_attn + static_cast<long long>(b) * T * L;
    if (warp >= MAX_WARPS && warp < COURIER) {
      // copy warps: the rows of block m, columns c0 - 32 .. c0 + 128 n_warps - 1
      // (zero outside [0, L)), into ring rows (row % 48). A lane's columns are
      // the same in every row, so where they lie and whether they are in the
      // text is settled once: a row's copies are then a pointer step and
      // WIDE_CHUNKS (or NARROW_CHUNKS) cp.async, with no index arithmetic
      const int c = (warp - MAX_WARPS) * 32 + lane;  // of 128 copy lanes
      const int width = EDGE + n_warps * 32 * COLS;
      const bool wide = (L & 3) == 0 && (reinterpret_cast<uintptr_t>(log_attn) & 15) == 0;
      const int step = wide ? 4 : 1;  // columns a copy
      int at[NARROW_CHUNKS];          // ring column of copy k (width or more: none)
      int from[NARROW_CHUNKS];        // its log_attn column, or -1 (zero fill)
#pragma unroll
      for (int k = 0; k < NARROW_CHUNKS; ++k) {
        at[k] = step * (c + 32 * COPY_WARPS * k);
        const int g = c0 - EDGE + at[k];
        from[k] = g >= 0 && g < L ? g : -1;
      }
      auto copy_block = [&](int m) {
        if (m < n_blocks) {
          const int last = min(n, (m + 1) * BLOCK);
          float* dst = ring + (m % SLOTS) * BLOCK * SLICE_ROW;
          const float* src = la_b + static_cast<long long>(m) * BLOCK * L;
          for (int i = m * BLOCK; i < last; ++i, dst += SLICE_ROW, src += L) {
            if (!FS2T_MAS_STAGE) continue;  // a timing only: nothing staged
            if (wide) {
#pragma unroll
              for (int k = 0; k < WIDE_CHUNKS; ++k)
                if (at[k] < width)
                  fs2::tc::cp_async16(dst + at[k], from[k] >= 0 ? src + from[k] : la_b,
                                      from[k] >= 0);
            } else {
#pragma unroll
              for (int k = 0; k < NARROW_CHUNKS; ++k)
                if (at[k] < width)
                  fs2::tc::cp_async4(dst + at[k], from[k] >= 0 ? src + from[k] : la_b,
                                     from[k] >= 0);
            }
          }
        }
        fs2::tc::cp_async_commit();
      };
      copy_block(0);
      copy_block(1);
      for (int m = 0; m < n_blocks; ++m) {
        if (m > 0) copy_block(m + 1);
        fs2::tc::cp_async_wait<1>();  // block m has landed
        bar_sync(1, n_meet);          // and is handed over
      }
    } else if (warp == COURIER) {
      // the halo across the block boundaries, hand-over m - 1 at meet m (the
      // columns of row 16 m - 1): from the left block's `edge` slot into
      // edge_in before the meet, and from the last search warp's `halo` into
      // the right block's slot after it. A warp of its own: a release waits
      // for its thread's memory operations, which for a copy warp would be
      // cp.async copies still in flight. Across a panel boundary the
      // hand-over goes through device memory (edge_out_g, then edge_in_g of
      // the next launch)
      for (int m = 0; m < n_blocks; ++m) {
        const int slot = (m - 1) % EDGE_SLOTS;
        const uint32_t parity = ((m - 1) / EDGE_SLOTS) & 1;
        if (m > 0 && rank > 0) {
          fs2::cluster::wait(&full[slot], parity);
          edge_in[m & 1][lane] = edge[slot][lane];
          fs2::cluster::arrive(fs2::cluster::map(&empty[slot], rank - 1));
        } else if (m > 0 && grank > 0) {
          edge_in[m & 1][lane] = edge_in_g[(edge_row0 + m) * EDGE + lane];
        }
        bar_sync(1, n_meet);
        if (m > 0 && feeds) {
          const float v = halo[m & 1][MAX_WARPS - 1][lane];
          if (rank + 1 < size) {
            fs2::cluster::wait(&empty[slot], parity ^ 1);  // the right block took the slot's last
            fs2::cluster::store(fs2::cluster::map(&edge[slot][lane], rank + 1), v);
            fs2::cluster::arrive(fs2::cluster::map(&full[slot], rank + 1));
          } else {
            edge_out_g[(edge_row0 + m) * EDGE + lane] = v;
          }
        }
      }
    } else if (warp < n_warps) {
      const int jw = c0 + warp * 32 * COLS + lane;  // columns jw + 32 k, and jw - 32 (halo)
      const bool has_halo = warp > 0 || grank > 0;
      const int n_groups = min(COLS, (in_len - (jw - lane) + 31) >> 5);  // with a live column
      const int word0 = (c0 >> 5) + warp * COLS;
      float cur[COLS + 1];  // P[i - 1, j] of the halo column and the owned ones
      uint32_t keep[COLS] = {};
      for (int i0 = 0; i0 < n; i0 += BLOCK) {
        const int block = i0 / BLOCK;
        const float* row =
            ring + (block % SLOTS) * BLOCK * SLICE_ROW + EDGE + warp * 32 * COLS + lane;
        if (i0 == 0) {
          bar_sync(1, n_meet);
          cur[0] = has_halo ? fmaxf(row[-32], NEG_INF) + NEG_INF : -INFINITY;
#pragma unroll
          for (int k = 0; k < COLS; ++k)
            cur[1 + k] = fmaxf(row[32 * k], NEG_INF) + (jw + 32 * k == 0 ? 0.f : NEG_INF);
        } else {  // meet, and take the halo afresh (warp 0: from the block on the left)
          halo[block & 1][warp][lane] = cur[COLS];
          bar_sync(1, n_meet);
          if (warp > 0)
            cur[0] = halo[block & 1][warp - 1][lane];
          else if (grank > 0)
            cur[0] = edge_in[block & 1][lane];
        }
        const int last = min(n, i0 + BLOCK);
#pragma unroll 4
        for (int i = max(i0, 1); i < last; ++i) {
          const float* x = row + (i - i0) * SLICE_ROW;
          mas_row<COLS>(cur, keep, [&](int g) { return g == 0 ? x[-32] : x[32 * (g - 1)]; }, i,
                        n, has_halo, word0, lane, n_groups, bits_b, T);
        }
      }
    }
  }
  // every block's decision words are out before the backtrack reads them,
  // and no block leaves while a neighbour may still touch its shared memory
  fs2::cluster::sync();
  if (rank != 0 || warp != 0 || !backtracks) return;
  __syncwarp();
  backtrack(hard, durations, bits_b, b, T, L, in_len, n, lane);
}

// The panels of a text of L columns: ceil(L / PANEL_L), each of at most
// PANEL_BLOCKS blocks.
int panels(int L) { return (L + PANEL_L - 1) / PANEL_L; }

// The panels in turn on `stream`: panel p reads its hand-overs from half
// (p - 1) % 2 of `edge` ([2][B][ceil(T / 16)][32] f32; null for one panel)
// and writes them to half p % 2, which the launch before it read last.
cudaError_t launch_cluster(const void* log_attn, const void* in_lens, const void* out_lens,
                           void* hard, void* durations, void* bits, void* edge, int B, int T,
                           int L, cudaStream_t stream) {
  const cudaError_t attr = fs2::smem_opt_in(cluster_opt_in, mas_width1_cluster_kernel,
                                            static_cast<int>(CLUSTER_SMEM));
  if (attr != cudaSuccess) return attr;
  const int n_panels = panels(L);
  if (n_panels > 1 && edge == nullptr) return cudaErrorInvalidValue;
  const long long half = static_cast<long long>(B) * ((T + BLOCK - 1) / BLOCK) * EDGE;
  float* const edges = static_cast<float*>(edge);
  for (int p = 0; p < n_panels; ++p) {
    const int size = min(PANEL_BLOCKS, (L - p * PANEL_L + SLICE_L - 1) / SLICE_L);
    const float* from = p > 0 ? edges + ((p - 1) & 1) * half : nullptr;
    float* to = p + 1 < n_panels ? edges + (p & 1) * half : nullptr;
    const cudaError_t err = fs2::cluster::launch(
        cluster_occupancy, mas_width1_cluster_kernel, B * size, size, CLUSTER_THREADS,
        CLUSTER_SMEM, stream, static_cast<const float*>(log_attn),
        static_cast<const int*>(in_lens), static_cast<const int*>(out_lens),
        static_cast<float*>(hard), static_cast<int*>(durations), static_cast<uint32_t*>(bits),
        from, to, T, L, p * PANEL_BLOCKS, static_cast<int>(p + 1 == n_panels));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

FS2_EXPORT_ERROR_STRING

// The cluster layout the kernel was built for, as ops/mas.py names it
// (SLICE_L, EDGE, MEET_ROWS, PANEL_L): a launch given another refuses.
static bool layout_is(int slice, int edge, int meet, int panel) {
  return slice == SLICE_L && edge == EDGE && meet == BLOCK && panel == PANEL_L;
}

// Zeroes hard and durations on `stream`, then launches the search there:
// the ring kernel up to L 1024, the cluster kernel past it, in panels past
// 8192 (`edge`: their hand-overs, [2][B][ceil(T / 16)][32] f32, unread for
// one panel). Returns a cudaError_t code (0 on success).
extern "C" int mas_width1(const void* log_attn, const void* in_lens, const void* out_lens,
                          void* hard, void* durations, void* bits, void* edge, int B, int T,
                          int L, int slice, int edge_columns, int meet, int panel, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || !layout_is(slice, edge_columns, meet, panel))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(hard, 0, sizeof(float) * static_cast<size_t>(B) * T * L, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(durations, 0, sizeof(int) * static_cast<size_t>(B) * L, st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define FS2_MAS_ARGS log_attn, in_lens, out_lens, hard, durations, bits, B, T, L, st
  if (L <= 32 * MAX_WARPS) return static_cast<int>(launch<1>(FS2_MAS_ARGS));
  if (L <= 64 * MAX_WARPS) return static_cast<int>(launch<2>(FS2_MAS_ARGS));
  if (L <= RING_L) return static_cast<int>(launch<4>(FS2_MAS_ARGS));
#undef FS2_MAS_ARGS
  return static_cast<int>(
      launch_cluster(log_attn, in_lens, out_lens, hard, durations, bits, edge, B, T, L, st));
}

// The layout a launch at text length L takes: out[0] blocks a cluster of
// the first panel (1: the ring kernel), out[1] columns a block owns, out[2]
// halo columns a block takes from its left neighbour, out[3] rows between
// two meets, out[4] the clusters of out[0] blocks the card holds at once (0
// for the ring kernel), out[5] the panels launched in turn.
extern "C" int mas_width1_cluster_layout(int L, int* out) {
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= RING_L) {
    out[0] = 1, out[1] = L, out[2] = 32, out[3] = BLOCK, out[4] = 0, out[5] = 1;
    return 0;
  }
  cudaError_t err = fs2::smem_opt_in(cluster_opt_in, mas_width1_cluster_kernel,
                                     static_cast<int>(CLUSTER_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = min(PANEL_BLOCKS, (L + SLICE_L - 1) / SLICE_L);
  out[0] = size, out[1] = SLICE_L, out[2] = EDGE, out[3] = BLOCK, out[5] = panels(L);
  err = fs2::cluster::max_active(cluster_occupancy, mas_width1_cluster_kernel, size,
                                 CLUSTER_THREADS, CLUSTER_SMEM, &out[4]);
  return static_cast<int>(err);
}
