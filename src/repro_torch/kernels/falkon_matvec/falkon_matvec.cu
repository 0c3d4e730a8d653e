// K2-K4 and K7: the FALKON K_nM contractions on Hopper (sm_90a), hand-written CUDA C++.
// K_nM = k(X, Z) is never stored: every Gram value is built on chip,
// contracted, and dropped.
//
//   K4 knm_matvec    O = K_nM A        replaces falkon_matvec.py:221 `knm_matvec_pallas`
//   K3 knm_t         R = K_nM^T Y      replaces falkon_matvec.py:184 `knm_t_pallas`
//   K2 falkon_matvec R = K_nM^T K_nM V replaces falkon_matvec.py:93  `falkon_matvec_pallas`
//   K7 falkon_matvec_masked            replaces falkon_matvec.py:139 `falkon_matvec_masked_pallas`
//                    R[:, j] = K_nM^T diag(mask[:, j]) K_nM V[:, j]
//
// The host launchers (declared in ../csrc/launchers.h) each enqueue one
// kernel; ../csrc/binding.cpp sequences them per entry point and checks
// every launch.
//
// What bounds them on this card: the Gram values. At the main path's shapes
// (n = 10^6 rows, M = 10^4 centers, d = 18, k = 1) the inputs are ~72 MB and
// the outputs at most 0.4 MB, so the bytes bound is ~0.02 ms; each K_nM
// evaluation is ~2 n M d = 3.6e11 fp32 FMA-FLOPs plus n M exps, i.e. ~6 ms
// at the 67 TFLOP/s fp32 peak. Counted in issued instructions (18 FMAs, the
// distance, an IEEE expf and the contractions: ~36 per value), one build of
// the 10^10 values takes ~12 ms at the card's issue rate. They are bound by
// operations.
//
// K4 (knm_matvec) is K3's register kernel on the transposed problem:
// k(X, Z) A = k(Z, X)^T A, so the rows of X take the place of K3's centers
// and the centers that of its rows. Two routes, chosen by shape alone
// (ops.knm_matvec_plan):
//  * "register" (d <= 32): `knm_t_reg_kernel` with x and z swapped, grid
//    (512-row slices, center chunks, column chunks of NC). Each thread keeps
//    its two rows' x (all of d) and norms in registers for the whole call;
//    the block walks its center chunk in 64-center tiles, each staged
//    feature-major with z's norms (one row_norms launch over z) and the
//    tile's rows of A by cp.async, double-buffered; per 8 centers each thread
//    builds its 2 x 8 Gram values in straight-line code, switches the family
//    epilogue once and adds the 8-term sums of G A into its (2, NC)
//    accumulator. G never leaves the registers. What holds the tiled
//    kernel back at these shapes is the barrier chain of the shared 64 x 64
//    `gram_tile` per 64 centers (DK = 8 staging, the norms re-reduced, G
//    through shared memory) and a contraction on 64 of 256 threads at
//    k = 1; this route has neither. Where the row slices alone give few
//    blocks (n = 10^5: 196) the centers are split into chunks, each writing
//    partial[chunk, n, k], added by `reduce_partials_blocked` in a fixed
//    order; with one chunk the kernel writes the output itself. K7's stage 1 multiplies the complete sum by
//    the mask exactly once: as the kernel writes it (one chunk) or in the
//    reduce (several), so an all-ones mask gives K2's stage 1 bit for bit.
//  * "tiled" (d above 32, where x no longer fits in registers):
//    `knm_matvec_kernel<MASKED>` on the shared `gram_tile`, one block per
//    64-row tile looping over M in 64-center chunks.
//
// K3 (knm_t): the TPU kernel accumulates one resident (M, k) block over a
// *sequential* grid. Hopper blocks run in parallel and in no order, so the
// sum is a fixed-order two-stage one: each block sums its row chunk into
// partial[chunk], then a second launch adds the chunks. No float atomics:
// the result is bit-repeatable for a given (n, M, d, k). Two routes, chosen
// by shape alone (ops.knm_t_plan):
//  * "register" (d <= 32): `knm_t_reg_kernel`, grid (512-center slices, row
//    chunks, column chunks of NC = 1, 2, 4, 5 or 8). Thread t owns centers
//    2t, 2t + 1 of the slice: their z rows (over the whole of d) and norms
//    stay in its registers for the whole call. The block walks its row chunk
//    in 64-row tiles, each staged feature-major with its norms and Y columns
//    by cp.async, double-buffered; per 8 rows each thread builds its 8 x 2
//    Gram values in straight-line code (one jump per tile into a
//    fall-through over the features, the x values shared-memory broadcasts),
//    switches the family epilogue once, and adds the 8-row sums of G Y into
//    its (2, NC) accumulator. G never leaves the registers and no two
//    threads share an output, so a chunk's sum needs no exchange. A first
//    launch writes the rows' squared norms; `reduce_partials_blocked` adds
//    the chunks in groups of 32. The plan gives ~2 048 blocks and chunks of
//    at most 16 384 rows, so each thread's chain is at most 2 048 8-row sums
//    (chip_smoke.py phase 4's refit gate feels this order). Also stage 2 of
//    K2/K7's two-stage route.
//  * "tiled" (d above 32, where the z rows no longer fit in registers):
//    `knm_t_partial_kernel`, block (64-center tile, row chunk) on the shared
//    `gram_tile`, its chunks added in index order by `reduce_partials`.
//
// K2 and K7 have two routes, chosen by shape alone (ops.matvec_plan):
//  * "cluster" (M up to 12 288 at d = 18 and k = 1; d <= 64):
//    `falkon_matvec_fused_kernel`, one kernel templated on MASKED (K7) that
//    builds each Gram value once per call. T = K_nM V must be complete over
//    all M before G^T T; the TPU keeps the (bn, M) tile in VMEM, which at
//    M = 10^4 (0.6 MB for 16 rows) does not fit in a block's 227 KB. So the
//    M centers are split over a thread-block cluster of C <= 8 blocks (the
//    portable size; the fewest that fit), block b holding a 256-aligned
//    slice of ~M / C centers: its z slice (feature-major), their norms and V
//    rows stay in its shared memory for the whole call, one block per SM.
//    Clusters are persistent (as many as cudaOccupancyMaxActiveClusters
//    allows) and walk over work items (column chunk, row chunk) in a static
//    stride. A first launch
//    writes the rows' squared norms. Per 16-row tile each block of 512
//    threads
//      1. builds G[16, slice] once: the x tile staged feature-major (its
//         rows and norms prefetched into registers a tile ahead), each
//         thread a 4 x 2 register tile over the whole of d (no per-DK
//         barriers; a warp's x and z fragment loads one wavefront each), the
//         family epilogue switched once per tile, G kept in shared memory;
//      2. contracts it against its V rows into a partial T_b (16, NC) in
//         registers, summed over a row's 8 column lanes by a fixed-order
//         reduce-scatter of warp shuffles, then over the 16 warps in order;
//      3. writes T_b into slot `rank` of every block's shared memory
//         (distributed shared memory stores), then one cluster barrier
//         (barrier.cluster arrive.release / wait.acquire; the slots
//         double-buffered, so one barrier per tile suffices; the next tile's
//         x is staged while it completes); each block adds the C slots in
//         rank order, so every block holds the same T, bit for bit. MASKED
//         multiplies T by the tile's mask rows (loaded a tile ahead), so an
//         all-ones mask gives K2's result bit for bit (`* 1.0f` is exact);
//      4. adds G_slice^T T into its slice's (slice, NC) accumulator in shared
//         memory, each thread owning whole columns, two at a time.
//    At the end of a row chunk each block writes partial[chunk, slice, k];
//    `reduce_partials_blocked` adds the chunks in a fixed order, in groups
//    of 32 (a single running sum over ~1 000 chunks drifted further from
//    cuBLAS's sums: chip_smoke.py phase 4's refit agreement read 1.06e-3
//    against its 1e-3 gate). The split is a
//    function of (n, M, d, k) alone, not of how many clusters the card runs
//    at once, so the result is bit-repeatable for a given shape. Output
//    columns go NC (1, 2, 4, 5 or 8) at a time: the CV sweep's 5 folds in
//    one chunk, without 3 idle columns.
//    What holds it at ~5x its bound (chip_smoke.py phase 6): the build
//    itself, well below the card's issue rate with one 16-warp block per
//    SM, and the per-tile chain of barriers, the exchange and step 4 around
//    it.
//  * "two-stage" (above that cap): stage 1 is K4 writing T (n, k) to device
//    memory by K4's own plan (K7 multiplies T by the mask), stage 2 K3 on T
//    by K3's own plan. Twice the Gram builds of the fused reference; at
//    d <= 32 both run the register kernel.
//  * Rows >= n and centers >= M are masked inside the kernels; nothing is
//    padded, d and k are used as given.
#include <cooperative_groups.h>

#include "cp_async.cuh"
#include "gram_tile.cuh"
#include "launchers.h"
#include "tile_epilogue.cuh"

using namespace repro;

namespace {

constexpr int KC = 32;                          // output columns per block
constexpr int OWN = TILE * KC / THREADS;        // outputs each thread owns (8)

// Write this thread's Gram sub-tile into the shared (TILE, TILE) buffer.
__device__ __forceinline__ void store_tile(float gs[TILE][TILE + 1], float g[PER][PER]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) gs[ty + 16 * i][tx + 16 * j] = g[i][j];
}

// O[row tile, kc0:kc0+kw] = sum over center chunks of G A; one block per row
// tile. MASKED multiplies each output by mask (n, k) as it is written (K7).
template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
knm_matvec_kernel(const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ a, const float* __restrict__ mask,
                  float* __restrict__ out, int n, int m, int d, int k, int fam, float s,
                  int bf16) {
  __shared__ TileSmem sm;
  __shared__ float gs[TILE][TILE + 1];
  __shared__ float as[TILE][KC];
  const int row0 = blockIdx.x * TILE;
  const int kc0 = blockIdx.y * KC;
  const int kw = min(KC, k - kc0);
  const int tid = threadIdx.x;
  float acc[OWN];
#pragma unroll
  for (int q = 0; q < OWN; ++q) acc[q] = 0.0f;

  for (int col0 = 0; col0 < m; col0 += TILE) {
    float g[PER][PER];
    gram_tile(x, n, row0, z, m, col0, d, fam, s, bf16 != 0, sm, g);
    store_tile(gs, g);
    for (int idx = tid; idx < TILE * KC; idx += THREADS) {
      const int j = idx / KC, c = idx % KC;
      as[j][c] = (col0 + j < m && c < kw) ? a[(long long)(col0 + j) * k + kc0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      const int p = tid + THREADS * q;
      if (p < TILE * kw) {
        const int r = p / kw, c = p % kw;
        float sum = acc[q];
#pragma unroll 16
        for (int j = 0; j < TILE; ++j) sum = fmaf(gs[r][j], as[j][c], sum);
        acc[q] = sum;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < OWN; ++q) {
    const int p = tid + THREADS * q;
    if (p < TILE * kw) {
      const int r = p / kw, c = p % kw;
      if (row0 + r < n) {
        const long long o = (long long)(row0 + r) * k + kc0 + c;
        out[o] = MASKED ? acc[q] * mask[o] : acc[q];
      }
    }
  }
}

// K3 on the tiled route: partial[chunk, center tile, kc0:kc0+kw] = sum over
// the chunk's rows of G^T Y, rows taken in order. Grid: (center tiles, row
// chunks, column chunks).
__global__ void __launch_bounds__(THREADS)
knm_t_partial_kernel(const float* __restrict__ x, const float* __restrict__ z,
                     const float* __restrict__ y, float* __restrict__ partial,
                     int n, int m, int d, int k, int chunk_rows, int fam, float s, int bf16) {
  __shared__ TileSmem sm;
  __shared__ float gs[TILE][TILE + 1];
  __shared__ float ys[TILE][KC];
  const int col0 = blockIdx.x * TILE;
  const int chunk = blockIdx.y;
  const int kc0 = blockIdx.z * KC;
  const int kw = min(KC, k - kc0);
  const int rbeg = chunk * chunk_rows;
  const int rend = min(n, rbeg + chunk_rows);
  const int tid = threadIdx.x;
  float acc[OWN];
#pragma unroll
  for (int q = 0; q < OWN; ++q) acc[q] = 0.0f;

  for (int row0 = rbeg; row0 < rend; row0 += TILE) {
    float g[PER][PER];
    gram_tile(x, rend, row0, z, m, col0, d, fam, s, bf16 != 0, sm, g);
    store_tile(gs, g);
    for (int idx = tid; idx < TILE * KC; idx += THREADS) {
      const int r = idx / KC, c = idx % KC;
      ys[r][c] = (row0 + r < rend && c < kw) ? y[(long long)(row0 + r) * k + kc0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      const int p = tid + THREADS * q;
      if (p < TILE * kw) {
        const int j = p / kw, c = p % kw;
        float sum = acc[q];
#pragma unroll 16
        for (int r = 0; r < TILE; ++r) sum = fmaf(gs[r][j], ys[r][c], sum);
        acc[q] = sum;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < OWN; ++q) {
    const int p = tid + THREADS * q;
    if (p < TILE * kw) {
      const int j = p / kw, c = p % kw;
      if (col0 + j < m) partial[((long long)chunk * m + col0 + j) * k + kc0 + c] = acc[q];
    }
  }
}

// out[i] = sum over chunks, in index order, of partial[chunk, i]; i < len = M k.
__global__ void reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                       long long len, int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float sum = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) sum += partial[(long long)ch * len + i];
  out[i] = sum;
}

// ---------------------------------------------------------------------------
// K2 and K7 on the cluster route: each Gram value built once per call.
// ---------------------------------------------------------------------------

constexpr int FR = 16;                      // rows per tile
constexpr int FPASS = 256;                  // centers per build pass
constexpr int FNJ = 2;                      // centers per thread in a pass (rows: 4)
constexpr int FWARPS = FPASS / (8 * FNJ);   // a warp: 16 rows x 8 FNJ centers (16 warps)
constexpr int FTHREADS = 32 * FWARPS;
constexpr int FDMAX = 64;                   // largest d the route takes
constexpr int FXQ = FR * FDMAX / FTHREADS;  // x values each thread prefetches (2)
constexpr int FMAXC = 8;                    // largest cluster (the portable size)
static_assert(FR * FDMAX % FTHREADS == 0 && FR * 8 <= FTHREADS, "a block shape that divides");

// Offsets (in floats) into the block's dynamic shared memory for a slice of
// `sw` centers (a multiple of FPASS), d features and nc output columns; every
// region starts on a 16-byte boundary.
struct FusedLayout {
  int g, zs, zn, vs, oacc, xs, xn, wred, tpart, tfull, total;
};

__host__ __device__ inline FusedLayout fused_layout(int sw, int d, int nc) {
  FusedLayout l;
  l.g = 0;                              // [FR][sw]  the tile's Gram values
  l.zs = l.g + FR * sw;                 // [d][sw]   the slice's centers, feature-major
  l.zn = l.zs + d * sw;                 // [sw]      their squared norms
  l.vs = l.zn + sw;                     // [nc][sw]  their rows of V, this column chunk
  l.oacc = l.vs + nc * sw;              // [nc][sw]  G^T T over the row chunk
  l.xs = l.oacc + nc * sw;              // [2][d][FR] a tile's rows, feature-major (two tiles)
  l.xn = l.xs + 2 * d * FR;             // [2][FR]   their squared norms
  l.wred = l.xn + 2 * FR;               // [FWARPS][FR][nc] per-warp shares of T
  l.tpart = l.wred + FWARPS * FR * nc;  // [2][FMAXC][FR][nc] every block's T partial
  l.tfull = l.tpart + 2 * FMAXC * FR * nc;  // [FR][nc]  T
  l.total = l.tfull + FR * nc;
  return l;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [row0, row0 + FR) of x as stored, 0 from row rend on: element
// tid + FTHREADS q of the block into xp[q]; thread tid < FR also takes row
// row0 + tid's squared norm into xpn.
__device__ __forceinline__ void prefetch_x(float (&xp)[FXQ], float& xpn,
                                           const float* __restrict__ x,
                                           const float* __restrict__ xnorm, int row0, int rend,
                                           int d, int tid) {
  const long long valid = static_cast<long long>(rend - row0) * d;
  const float* src = x + static_cast<long long>(row0) * d;
#pragma unroll
  for (int q = 0; q < FXQ; ++q) {
    const int e = tid + FTHREADS * q;
    xp[q] = (e < FR * d && e < valid) ? src[e] : 0.0f;
  }
  xpn = tid < FR && row0 + tid < rend ? xnorm[row0 + tid] : 0.0f;
}

// The prefetched rows into xs_buf (feature-major; bf16: rounded) and their
// norms into xn_buf.
__device__ __forceinline__ void stage_x(const float (&xp)[FXQ], float xpn, float* xs_buf,
                                        float* xn_buf, int d, int bf16, int tid) {
#pragma unroll
  for (int q = 0; q < FXQ; ++q) {
    const int e = tid + FTHREADS * q;
    if (e < FR * d) {
      const int r = e / d, f = e - r * d;
      xs_buf[f * FR + r] = bf16 ? round_bf16(xp[q]) : xp[q];
    }
  }
  if (tid < FR) xn_buf[tid] = xpn;
}

// FNJ (2) consecutive floats of shared memory, 8-byte aligned, to registers
// and back.
static_assert(FNJ == 2, "the column fragments are float2");

__device__ __forceinline__ void load_cols(const float* p, float (&b)[FNJ]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  b[0] = t.x, b[1] = t.y;
}

__device__ __forceinline__ void store_cols(float* p, const float (&b)[FNJ]) {
  *reinterpret_cast<float2*>(p) = make_float2(b[0], b[1]);
}

// v[0..H) summed over the lanes that differ in lane bits LB, LB / 2, .., 1,
// in a fixed order: while a lane holds an even number of values, each step
// sends half of them to the partner and keeps the sum of the other half (a
// reduce-scatter); with an odd number left, the steps are a butterfly. On
// return the lane holds the sums of values idx .. idx + lane_kept(H, LB) in
// v[0 ..), and lanes that differ only in the butterfly's bits
// (lane_copies(H, LB)) hold the same sums.
__host__ __device__ constexpr int lane_kept(int h, int lb) {
  return lb == 0 ? h : h % 2 == 0 ? lane_kept(h / 2, lb / 2) : lane_kept(h, lb / 2);
}

__host__ __device__ constexpr int lane_copies(int h, int lb) {
  return lb == 0 ? 0 : h % 2 == 0 ? lane_copies(h / 2, lb / 2) : lb | lane_copies(h, lb / 2);
}

template <int H, int LB, int V>
__device__ __forceinline__ void lane_sum(float (&v)[V], int lane, int& idx) {
  if constexpr (LB > 0) {
    if constexpr (H % 2 == 0) {
      const bool up = (lane & LB) != 0;
#pragma unroll
      for (int q = 0; q < H / 2; ++q) {
        const float keep = up ? v[q + H / 2] : v[q];
        const float give = up ? v[q] : v[q + H / 2];
        v[q] = keep + __shfl_xor_sync(0xffffffffu, give, LB);
      }
      if (up) idx += H / 2;
      lane_sum<H / 2, LB / 2>(v, lane, idx);
    } else {
#pragma unroll
      for (int q = 0; q < H; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], LB);
      lane_sum<H, LB / 2>(v, lane, idx);
    }
  }
}

// partial[chunk, base .. base + width, kc0 .. kc0 + kw] for every work item
// (column chunk, row chunk) of this cluster, where block `rank` of the
// cluster owns centers [base, base + width), base = rank * sw. MASKED (K7)
// multiplies T by mask (n, k) before G^T T.
template <bool MASKED, int NC>
__global__ void __launch_bounds__(FTHREADS, 1)
falkon_matvec_fused_kernel(const float* __restrict__ x, const float* __restrict__ z,
                           const float* __restrict__ v, const float* __restrict__ mask,
                           const float* __restrict__ xnorm, float* __restrict__ partial, int n,
                           int m, int d, int k, int sw, int chunk_rows, int n_chunks, int fam,
                           float s, int bf16) {
  extern __shared__ __align__(16) float dyn[];
  namespace coop = cooperative_groups;
  coop::cluster_group cluster = coop::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / csize, n_clusters = gridDim.x / csize;
  const FusedLayout L = fused_layout(sw, d, NC);
  float* gs = dyn + L.g;
  float* zs = dyn + L.zs;
  float* zn = dyn + L.zn;
  float* vs = dyn + L.vs;
  float* oacc = dyn + L.oacc;
  float* wred = dyn + L.wred;
  float* tpart = dyn + L.tpart;
  float* tfull = dyn + L.tfull;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // lane (lr, lc) of warp w: rows 4 lr + i and slice columns p0 + cw + j of a
  // pass, cw = 8 FNJ w + FNJ lc, so an x fragment load covers 64 contiguous
  // bytes and a z fragment load 8 * 8 FNJ: one wavefront each
  const int lr = lane / 8, lc = lane % 8, cw = 8 * FNJ * warp + FNJ * lc;
  const int base = rank * sw;
  const int width = max(0, min(m, base + sw) - base);

  // The slice, once per call: z feature-major (bf16: rounded), its norms from
  // the unrounded values.
  for (int e = tid; e < sw * d; e += FTHREADS) {
    const int j = e / d, f = e - j * d;
    const float val = j < width ? z[static_cast<long long>(base + j) * d + f] : 0.0f;
    zs[f * sw + j] = bf16 ? round_bf16(val) : val;
  }
  for (int j = tid; j < sw; j += FTHREADS) {
    float acc = 0.0f;
    if (j < width) {
      const float* zr = z + static_cast<long long>(base + j) * d;
      for (int f = 0; f < d; ++f) acc = fmaf(zr[f], zr[f], acc);
    }
    zn[j] = acc;
  }

  const int items = (k + NC - 1) / NC * n_chunks;
  int buf = 0;
  for (int item = cid; item < items; item += n_clusters) {
    const int kc0 = item / n_chunks * NC, chunk = item % n_chunks;
    const int kw = min(NC, k - kc0);
    const int rbeg = min(n, chunk * chunk_rows), rend = min(n, rbeg + chunk_rows);
    __syncthreads();  // the previous item is done with vs
    for (int e = tid; e < NC * sw; e += FTHREADS) {
      const int c = e / sw, j = e - c * sw;
      vs[e] = (c < kw && j < width) ? v[static_cast<long long>(base + j) * k + kc0 + c] : 0.0f;
    }
    for (int j = tid; j < sw; j += FTHREADS)  // the columns this thread owns in step F
#pragma unroll
      for (int c = 0; c < NC; ++c) oacc[c * sw + j] = 0.0f;
    // K7: this thread's mask entry T[tid / NC, tid % NC] of a tile, 1 where
    // T is 0 anyway (rows past rend, columns past kw); loaded a tile ahead
    auto mask_entry = [&](int r0) {
      const int r = tid / NC, c = tid - r * NC;
      return (MASKED && tid < FR * NC && r0 + r < rend && c < kw)
                 ? mask[static_cast<long long>(r0 + r) * k + kc0 + c]
                 : 1.0f;
    };
    float xp[FXQ], xpn, mcur = 1.0f;
    int xb = 0;  // the xs and xn buffers of the current tile
    if (rbeg < rend) {
      prefetch_x(xp, xpn, x, xnorm, rbeg, rend, d, tid);
      if constexpr (MASKED) mcur = mask_entry(rbeg);
      stage_x(xp, xpn, dyn + L.xs, dyn + L.xn, d, bf16, tid);
      if (rbeg + FR < rend) prefetch_x(xp, xpn, x, xnorm, rbeg + FR, rend, d, tid);
    }

    for (int row0 = rbeg; row0 < rend; row0 += FR) {
      // The tile's rows and norms are in place; step F of the last tile is done.
      __syncthreads();

      // C. G[tile, slice] into shared memory, and this block's share of
      //    T = G V in registers; 4 x 4 register tiles over the whole of d.
      const float* xs = dyn + L.xs + xb * d * FR;
      constexpr int V = 4 * NC;
      float tp[V];  // T shares of rows 4 lr + i, column c at i NC + c
#pragma unroll
      for (int q = 0; q < V; ++q) tp[q] = 0.0f;
      const float4 xn4 = *reinterpret_cast<const float4*>(dyn + L.xn + xb * FR + 4 * lr);
      const float xni[4] = {xn4.x, xn4.y, xn4.z, xn4.w};
      const int rows = rend - row0;
      for (int p0 = 0; p0 < width; p0 += FPASS) {
        const int c0 = p0 + cw;
        float g[4][FNJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < FNJ; ++j) g[i][j] = 0.0f;
        const float* xa = xs + 4 * lr;
        const float* zb = zs + c0;
#pragma unroll 4
        for (int f = 0; f < d; ++f) {
          const float4 a4 = *reinterpret_cast<const float4*>(xa + f * FR);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          float b[FNJ];
          load_cols(zb + f * sw, b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < FNJ; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
        }
        float znj[FNJ];
        load_cols(zn + c0, znj);
        tile_epilogue(fam, g, xni, znj, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < FNJ; ++j)
            if (4 * lr + i >= rows || c0 + j >= width) g[i][j] = 0.0f;
          store_cols(gs + (4 * lr + i) * sw + c0, g[i]);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float vj[FNJ];
          load_cols(vs + c * sw + c0, vj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float t = tp[i * NC + c];
#pragma unroll
            for (int j = 0; j < FNJ; ++j) t = fmaf(g[i][j], vj[j], t);
            tp[i * NC + c] = t;
          }
        }
      }

      // D. The block's T partial: a row's 8 lanes in a fixed-order
      //    reduce-scatter, then its 8 warps in order.
      int idx = 0;
      lane_sum<V, 4>(tp, lane, idx);
      if ((lc & lane_copies(V, 4)) == 0) {
#pragma unroll
        for (int q = 0; q < lane_kept(V, 4); ++q) wred[(warp * 4 + lr) * V + idx + q] = tp[q];
      }
      __syncthreads();
      // The block's partial goes into slot `rank` of every block's tpart[buf],
      // through distributed shared memory.
      float* tpb = tpart + buf * FMAXC * FR * NC;
      if (tid < FR * NC) {
        float t = wred[tid];
#pragma unroll
        for (int w = 1; w < FWARPS; ++w) t += wred[w * FR * NC + tid];
#pragma unroll
        for (int b = 0; b < FMAXC; ++b)
          if (b < csize) cluster.map_shared_rank(tpb + rank * FR * NC, b)[tid] = t;
      }

      // E. T: the C partials, in this block's own shared memory after one
      //    cluster barrier, added in rank order, so every block holds the same
      //    T. A block writes into tpart[buf] again two tiles later, after the
      //    next barrier, which every block passes only when it has read this
      //    one. While the barrier completes, the next tile's rows go to the
      //    other xs buffer.
      cluster_arrive();
      const bool next = row0 + FR < rend;
      float mnext = 1.0f;
      if (next) {
        stage_x(xp, xpn, dyn + L.xs + (xb ^ 1) * d * FR, dyn + L.xn + (xb ^ 1) * FR, d, bf16,
                tid);
        if (row0 + 2 * FR < rend) prefetch_x(xp, xpn, x, xnorm, row0 + 2 * FR, rend, d, tid);
        if constexpr (MASKED) mnext = mask_entry(row0 + FR);
      }
      cluster_wait();
      if (tid < FR * NC) {
        float t = tpb[tid];
#pragma unroll
        for (int b = 1; b < FMAXC; ++b)
          if (b < csize) t += tpb[b * FR * NC + tid];
        if constexpr (MASKED) t *= mcur;
        tfull[tid] = t;
      }
      mcur = mnext;
      __syncthreads();

      // F. oacc += G_slice^T T; each thread owns whole columns j = tid + FTHREADS s.
      if constexpr (FR * NC <= 32) {
        float tr[FR * NC];
#pragma unroll
        for (int u = 0; u < FR * NC; ++u) tr[u] = tfull[u];
        for (int j = tid; j < width; j += FTHREADS) {
          float a[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) a[c] = 0.0f;
#pragma unroll
          for (int r = 0; r < FR; ++r) {
            const float gv = gs[r * sw + j];
#pragma unroll
            for (int c = 0; c < NC; ++c) a[c] = fmaf(gv, tr[r * NC + c], a[c]);
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) oacc[c * sw + j] += a[c];
        }
      } else {
        // two columns at a time, so that each row of T is read once for both
        for (int j = tid; j < width; j += 2 * FTHREADS) {
          const int j2 = j + FTHREADS;
          const bool two = j2 < width;
          float a[NC], a2[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) a[c] = a2[c] = 0.0f;
#pragma unroll 4
          for (int r = 0; r < FR; ++r) {
            float tr[NC];
            if constexpr (NC % 4 == 0) {
#pragma unroll
              for (int c4 = 0; c4 < NC; c4 += 4) {
                const float4 t4 = *reinterpret_cast<const float4*>(tfull + r * NC + c4);
                tr[c4] = t4.x, tr[c4 + 1] = t4.y, tr[c4 + 2] = t4.z, tr[c4 + 3] = t4.w;
              }
            } else {
#pragma unroll
              for (int c = 0; c < NC; ++c) tr[c] = tfull[r * NC + c];
            }
            const float gv = gs[r * sw + j], gv2 = two ? gs[r * sw + j2] : 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              a[c] = fmaf(gv, tr[c], a[c]);
              a2[c] = fmaf(gv2, tr[c], a2[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            oacc[c * sw + j] += a[c];
            if (two) oacc[c * sw + j2] += a2[c];
          }
        }
      }
      xb ^= 1;
      buf ^= 1;
    }

    // The row chunk's share of this slice, read back by the threads that wrote it.
    for (int j = tid; j < width; j += FTHREADS)
      for (int c = 0; c < kw; ++c)
        partial[(static_cast<long long>(chunk) * m + base + j) * k + kc0 + c] = oacc[c * sw + j];
  }
  cluster.sync();  // no block leaves while a peer may still read its T partials
}

template <bool MASKED, int NC>
void launch_fused(const float* x, const float* z, const float* v, const float* mask,
                  const float* xnorm, float* partial, int n, int m, int d, int k, int cluster,
                  int sw, int chunk_rows, int n_chunks, int fam, float s, bool bf16,
                  cudaStream_t st) {
  const auto kernel = falkon_matvec_fused_kernel<MASKED, NC>;
  const int smem = fused_layout(sw, d, NC).total * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // Persistent clusters: as many as fit on the card at once. The work items
  // and the sum order do not depend on this count.
  int active = 0;
  cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(kernel), &cfg);
  const int items = (k + NC - 1) / NC * n_chunks;
  cfg.gridDim = dim3(max(1, min(active, items)) * cluster);
  cudaLaunchKernelEx(&cfg, kernel, x, z, v, mask, xnorm, partial, n, m, d, k, sw, chunk_rows,
                     n_chunks, fam, s, bf16 ? 1 : 0);
}

// The instantiation for NC output columns per work item (1, 2, 4, 5 or 8).
template <bool MASKED>
void launch_fused_kc(const float* x, const float* z, const float* v, const float* mask,
                     const float* xnorm, float* partial, int n, int m, int d, int k, int cluster,
                     int sw, int kc, int chunk_rows, int n_chunks, int fam, float s, bool bf16,
                     cudaStream_t st) {
  const auto launch = kc == 1   ? launch_fused<MASKED, 1>
                      : kc == 2 ? launch_fused<MASKED, 2>
                      : kc == 4 ? launch_fused<MASKED, 4>
                      : kc == 5 ? launch_fused<MASKED, 5>
                                : launch_fused<MASKED, 8>;
  launch(x, z, v, mask, xnorm, partial, n, m, d, k, cluster, sw, chunk_rows, n_chunks, fam, s,
         bf16, st);
}

// out[i] = the sum over chunks of partial[chunk, i], i < len, taken as
// groups of RGROUP chunks in index order, each summed in order, and the
// group sums added in order: a fixed order, and no chain longer than
// RGROUP + n_chunks / RGROUP for the cluster route's ~1 000 row chunks.
// With a mask (K7's split stage 1) the sum is multiplied by mask[i].
constexpr int RGROUP = 32;

__global__ void reduce_partials_blocked_kernel(const float* __restrict__ partial,
                                               const float* __restrict__ mask,
                                               float* __restrict__ out, long long len,
                                               int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float total = 0.0f;
  for (int g0 = 0; g0 < n_chunks; g0 += RGROUP) {
    float group = 0.0f;
    for (int ch = g0; ch < min(n_chunks, g0 + RGROUP); ++ch)
      group += partial[(long long)ch * len + i];
    total += group;
  }
  out[i] = mask != nullptr ? total * mask[i] : total;
}

// ---------------------------------------------------------------------------
// K3 on the register route (d <= KT_DMAX): G built and contracted in registers.
// ---------------------------------------------------------------------------

constexpr int KT_THREADS = 256;
constexpr int KT_NJ = 2;                         // centers per thread
constexpr int KT_SLICE = KT_THREADS * KT_NJ;     // centers per block (512)
constexpr int KT_ROWS = 64;                      // rows per staged tile
constexpr int KT_NI = 8;                         // rows per register tile
constexpr int KT_DMAX = 32;                      // largest d the route takes
constexpr int KT_XS = KT_ROWS + 4;               // x tile stride: 16-byte rows, 2-way bank conflicts
static_assert(KT_ROWS % KT_NI == 0 && KT_NI == 8, "a register tile is two float4 of rows");

// Offsets (in floats) into the block's dynamic shared memory for d features
// and nc output columns; every region starts on a 16-byte boundary.
struct KnmTLayout {
  int xs, xn, ys, total;
};

__host__ __device__ inline KnmTLayout knm_t_layout(int d, int nc) {
  KnmTLayout l;
  l.xs = 0;                          // [2][d][KT_XS] two tiles' rows, feature-major
  l.xn = l.xs + 2 * d * KT_XS;       // [2][KT_ROWS]  their squared norms
  l.ys = l.xn + 2 * KT_ROWS;         // [2][nc][KT_ROWS] their Y columns kc0 .. kc0 + nc
  l.total = l.ys + 2 * nc * KT_ROWS;
  return l;
}

__device__ __forceinline__ void cp_async_wait_all_but(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One feature F of an 8 x 2 register tile: g[i][j] += x[r0 + i][F] z_j[F].
template <int F>
__device__ __forceinline__ void kt_feature(float (&g)[KT_NI][KT_NJ], const float* xs, int r0,
                                           const float (&zr)[KT_NJ][KT_DMAX]) {
  const float4 a0 = *reinterpret_cast<const float4*>(xs + F * KT_XS + r0);
  const float4 a1 = *reinterpret_cast<const float4*>(xs + F * KT_XS + r0 + 4);
  const float a[KT_NI] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < KT_NI; ++i)
#pragma unroll
    for (int j = 0; j < KT_NJ; ++j) g[i][j] = fmaf(a[i], zr[j][F], g[i][j]);
}

// `case d:` enters the features at d - 1 and falls through to feature 0, so
// one jump per register tile replaces a test per feature.
#define KT_FEATURE(F)                \
  case (F) + 1:                      \
    kt_feature<(F)>(g, xs, r0, zr); \
    [[fallthrough]];
#define KT_FEATURES4(F) KT_FEATURE((F) + 3) KT_FEATURE((F) + 2) KT_FEATURE((F) + 1) KT_FEATURE(F)
static_assert(KT_DMAX == 32, "the switch below lists 32 features");

// partial[chunk, base .. base + KT_SLICE, kc0 .. kc0 + kw] = the chunk's
// rows of G^T Y, G = k(x, z slice). Grid: (center slices, row chunks,
// column chunks). Thread t owns centers base + 2t, base + 2t + 1: their z
// rows (bf16: rounded) and norms live in its registers for the whole call.
// The block walks its row chunk in KT_ROWS-row tiles, each staged
// feature-major with its norms and Y columns by cp.async, double-buffered.
// Per 8 rows each thread builds its 8 x 2 Gram values over the whole of d
// (straight-line code, features d - 1 down to 0; the x values are
// shared-memory broadcasts, every thread of the block reading the same
// ones), switches the family epilogue once, and adds
// sum_i G[i, j] Y[i, c] (an 8-term chain) into its accumulator of (j, c):
// G never leaves the registers, and no two threads share an output. Rows
// past rend are staged as zeros (x, norm and Y), so they add exactly 0.
// With a mask (K7's stage 1 on one chunk: partial is the output) each sum is
// multiplied by its mask entry as it is written. K4 runs this kernel with x
// and z swapped (see the header).
template <int NC, bool BF16>
__global__ void __launch_bounds__(KT_THREADS, 2)
knm_t_reg_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ y, const float* __restrict__ xnorm,
                 const float* __restrict__ mask, float* __restrict__ partial, int n, int m,
                 int d, int k, int chunk_rows, int fam, float s) {
  extern __shared__ __align__(16) float dyn[];
  const KnmTLayout L = knm_t_layout(d, NC);
  const int tid = threadIdx.x;
  const int chunk = blockIdx.y;
  const int kc0 = blockIdx.z * NC;
  const int kw = min(NC, k - kc0);
  const int rbeg = min(n, chunk * chunk_rows), rend = min(n, rbeg + chunk_rows);
  const int j0 = blockIdx.x * KT_SLICE + KT_NJ * tid;  // this thread's first center
  const bool active = j0 < m;

  float zr[KT_NJ][KT_DMAX], zn[KT_NJ];
#pragma unroll
  for (int j = 0; j < KT_NJ; ++j) {
    zn[j] = 0.0f;
    const bool valid = j0 + j < m;
    const float* zp = z + static_cast<long long>(j0 + j) * d;
#pragma unroll
    for (int f = 0; f < KT_DMAX; ++f) {
      const float v = (valid && f < d) ? zp[f] : 0.0f;
      zn[j] = fmaf(v, v, zn[j]);  // features in order; the zeros past d add exactly 0
      zr[j][f] = BF16 ? round_bf16(v) : v;
    }
  }
  float acc[KT_NJ][NC];
#pragma unroll
  for (int j = 0; j < KT_NJ; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[j][c] = 0.0f;

  // Tile rows [row0, row0 + KT_ROWS) into buffer b: x feature-major, its
  // norms, its Y columns; rows from rend on as zeros. Each thread copies the
  // same elements of every tile (the BF16 rounding pass relies on it).
  auto stage = [&](int row0, int b) {
    const int rows = rend - row0;
    float* xs = dyn + L.xs + b * d * KT_XS;
    const float* src = x + static_cast<long long>(row0) * d;
    for (int e = tid; e < KT_ROWS * d; e += KT_THREADS) {
      const int r = e / d, f = e - r * d;
      cp_async4(xs + f * KT_XS + r, src + (r < rows ? e : 0), r < rows ? 4 : 0);
    }
    if (tid < KT_ROWS)
      cp_async4(dyn + L.xn + b * KT_ROWS + tid, xnorm + row0 + (tid < rows ? tid : 0),
                tid < rows ? 4 : 0);
    for (int e = tid; e < NC * KT_ROWS; e += KT_THREADS) {
      const int c = e / KT_ROWS, r = e - c * KT_ROWS;
      const bool ok = r < rows && c < kw;
      cp_async4(dyn + L.ys + (b * NC + c) * KT_ROWS + r,
                y + (ok ? static_cast<long long>(row0 + r) * k + kc0 + c : 0), ok ? 4 : 0);
    }
    cp_async_commit();
  };

  const int tiles = (rend - rbeg + KT_ROWS - 1) / KT_ROWS;
  if (tiles > 0) stage(rbeg, 0);
  for (int t = 0; t < tiles; ++t) {
    const int b = t & 1, row0 = rbeg + t * KT_ROWS;
    const bool next = t + 1 < tiles;
    if (next) stage(row0 + KT_ROWS, b ^ 1);  // the other buffer, free since the last barrier
    cp_async_wait_all_but(next ? 1 : 0);     // this tile has landed
    float* xs = dyn + L.xs + b * d * KT_XS;
    if constexpr (BF16) {  // the cross term's operands rounded, the norms not
      for (int e = tid; e < KT_ROWS * d; e += KT_THREADS) {
        const int r = e / d, f = e - r * d;
        xs[f * KT_XS + r] = round_bf16(xs[f * KT_XS + r]);
      }
    }
    __syncthreads();
    if (active) {
      const float* xn = dyn + L.xn + b * KT_ROWS;
      const float* ys = dyn + L.ys + b * NC * KT_ROWS;
      const int rows = min(KT_ROWS, rend - row0);
      for (int r0 = 0; r0 < rows; r0 += KT_NI) {
        float g[KT_NI][KT_NJ];
#pragma unroll
        for (int i = 0; i < KT_NI; ++i)
#pragma unroll
          for (int j = 0; j < KT_NJ; ++j) g[i][j] = 0.0f;
        // features d - 1 down to 0, straight-line code entered at feature d - 1
        switch (d) {
          KT_FEATURES4(28) KT_FEATURES4(24) KT_FEATURES4(20) KT_FEATURES4(16)
          KT_FEATURES4(12) KT_FEATURES4(8) KT_FEATURES4(4) KT_FEATURES4(0)
          default: break;
        }
        const float4 n0 = *reinterpret_cast<const float4*>(xn + r0);
        const float4 n1 = *reinterpret_cast<const float4*>(xn + r0 + 4);
        const float xni[KT_NI] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
        tile_epilogue(fam, g, xni, zn, s);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 y0 = *reinterpret_cast<const float4*>(ys + c * KT_ROWS + r0);
          const float4 y1 = *reinterpret_cast<const float4*>(ys + c * KT_ROWS + r0 + 4);
          const float yv[KT_NI] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
          for (int j = 0; j < KT_NJ; ++j) {
            float t8 = g[0][j] * yv[0];
#pragma unroll
            for (int i = 1; i < KT_NI; ++i) t8 = fmaf(g[i][j], yv[i], t8);
            acc[j][c] += t8;
          }
        }
      }
    }
    __syncthreads();  // buffer b is free for the tile after next
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < KT_NJ; ++j) {
      if (j0 + j >= m) break;
      const long long o = (static_cast<long long>(chunk) * m + j0 + j) * k + kc0;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < kw) partial[o + c] = mask != nullptr ? acc[j][c] * mask[o + c] : acc[j][c];
    }
  }
}

// The instantiation for NC output columns per block (1, 2, 4, 5 or 8).
template <bool BF16>
void launch_knm_t_reg_bf(const float* x, const float* z, const float* y, const float* xnorm,
                         const float* mask, float* partial, int n, int m, int d, int k, int kc,
                         int chunk_rows, int n_chunks, int fam, float s, cudaStream_t st) {
  const auto kernel = kc == 1   ? knm_t_reg_kernel<1, BF16>
                      : kc == 2 ? knm_t_reg_kernel<2, BF16>
                      : kc == 4 ? knm_t_reg_kernel<4, BF16>
                      : kc == 5 ? knm_t_reg_kernel<5, BF16>
                                : knm_t_reg_kernel<8, BF16>;
  const int smem = knm_t_layout(d, kc).total * static_cast<int>(sizeof(float));
  const dim3 grid((m + KT_SLICE - 1) / KT_SLICE, n_chunks, (k + kc - 1) / kc);
  kernel<<<grid, KT_THREADS, smem, st>>>(x, z, y, xnorm, mask, partial, n, m, d, k, chunk_rows,
                                         fam, s);
}

// out[i] = |x_i|^2, the features summed in order; one thread per row.
__global__ void row_norms_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                 int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* xr = x + static_cast<long long>(i) * d;
  float a = 0.0f;
  for (int f = 0; f < d; ++f) a = fmaf(xr[f], xr[f], a);
  out[i] = a;
}

}  // namespace

void repro::launch_knm_matvec(const float* x, const float* z, const float* a, float* out,
                              int n, int m, int d, int k, int fam, float s, bool bf16,
                              cudaStream_t st) {
  const dim3 grid((n + TILE - 1) / TILE, (k + KC - 1) / KC);
  knm_matvec_kernel<false><<<grid, THREADS, 0, st>>>(x, z, a, nullptr, out, n, m, d, k, fam, s,
                                                     bf16);
}

void repro::launch_knm_matvec_masked(const float* x, const float* z, const float* a,
                                     const float* mask, float* out, int n, int m, int d, int k,
                                     int fam, float s, bool bf16, cudaStream_t st) {
  const dim3 grid((n + TILE - 1) / TILE, (k + KC - 1) / KC);
  knm_matvec_kernel<true><<<grid, THREADS, 0, st>>>(x, z, a, mask, out, n, m, d, k, fam, s,
                                                    bf16);
}

void repro::launch_knm_t_partial(const float* x, const float* z, const float* y,
                                 float* partial, int n, int m, int d, int k, int n_chunks,
                                 int chunk_rows, int fam, float s, bool bf16, cudaStream_t st) {
  const dim3 grid((m + TILE - 1) / TILE, n_chunks, (k + KC - 1) / KC);
  knm_t_partial_kernel<<<grid, THREADS, 0, st>>>(x, z, y, partial, n, m, d, k, chunk_rows,
                                                  fam, s, bf16);
}

void repro::launch_knm_t_reg(const float* x, const float* z, const float* y,
                             const float* xnorm, const float* mask, float* partial, int n, int m,
                             int d, int k, int kc, int chunk_rows, int n_chunks, int fam, float s,
                             bool bf16, cudaStream_t st) {
  if (bf16)
    launch_knm_t_reg_bf<true>(x, z, y, xnorm, mask, partial, n, m, d, k, kc, chunk_rows,
                              n_chunks, fam, s, st);
  else
    launch_knm_t_reg_bf<false>(x, z, y, xnorm, mask, partial, n, m, d, k, kc, chunk_rows,
                               n_chunks, fam, s, st);
}

void repro::launch_reduce_partials(const float* partial, float* out, long long len,
                                   int n_chunks, cudaStream_t st) {
  const int threads = 256;
  reduce_partials_kernel<<<(unsigned)((len + threads - 1) / threads), threads, 0, st>>>(
      partial, out, len, n_chunks);
}

long long repro::falkon_fused_smem_floats(int slice, int d, int kc) {
  return fused_layout(slice, d, kc).total;
}

void repro::launch_falkon_matvec_fused(const float* x, const float* z, const float* v,
                                       const float* mask, const float* xnorm, float* partial,
                                       int n, int m, int d, int k, int cluster, int slice, int kc,
                                       int chunk_rows, int n_chunks, int fam, float s, bool bf16,
                                       cudaStream_t st) {
  if (mask != nullptr)
    launch_fused_kc<true>(x, z, v, mask, xnorm, partial, n, m, d, k, cluster, slice, kc,
                          chunk_rows, n_chunks, fam, s, bf16, st);
  else
    launch_fused_kc<false>(x, z, v, mask, xnorm, partial, n, m, d, k, cluster, slice, kc,
                           chunk_rows, n_chunks, fam, s, bf16, st);
}

void repro::launch_reduce_partials_blocked(const float* partial, const float* mask, float* out,
                                           long long len, int n_chunks, cudaStream_t st) {
  const int threads = 256;
  reduce_partials_blocked_kernel<<<(unsigned)((len + threads - 1) / threads), threads, 0, st>>>(
      partial, mask, out, len, n_chunks);
}

void repro::launch_row_norms(const float* x, float* out, int n, int d, cudaStream_t st) {
  const int threads = 256;
  row_norms_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(x, out, n, d);
}
