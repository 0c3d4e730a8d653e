// K1: dense Gram matrix K(X, Z) on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/gram/gram.py:45 `gram_pallas` (one VMEM tile per
// (bn, bm) output block, MXU matmul + VPU family epilogue).
//
// What bounds it on this card: the (n, m) fp32 output. At the main path's
// shape (K_MM, n = m = 10^4, d = 18) the kernel writes 400 MB and does
// ~2 n m d = 3.6 GFLOP, so the write stream (0.12 ms at 3.35 TB/s) is the
// bound, not the fp32 FMA rate (0.05 ms at 67 TFLOP/s). Counted in issued
// instructions (18 FMAs with their shared-memory loads, the distance, an
// IEEE expf and a quarter of a store: ~36 per value) the 10^8 values take
// about as long again, so the build has to run under the stores, not before
// them.
//
// Two routes, chosen by shape alone (ops.gram_plan):
//  * "wide" (d <= 64) and "scalar" (the same kernel where m % 4 != 0, so that
//    rows are not 16-byte aligned): `gram_wide_kernel<VEC, BF16>`. A block
//    keeps a 128-row stripe of X (feature-major, with the rows' squared norms
//    from a row_norms launch) in shared memory and walks a run of 128-column
//    Z tiles, each staged whole-d with its norms by cp.async, double-buffered,
//    so one tile's stores are in flight while the next tile is built. Warp w
//    owns rows 16w .. 16w + 15 of the stripe and lane l columns 4l .. 4l + 3
//    of the tile: per feature one float4 of z and four broadcast float4 of x
//    feed 64 FMAs, then the family epilogue is switched once per tile and
//    each row leaves as one 16-byte streaming store per thread (__stcs; a
//    warp writes 512 contiguous bytes of a row). The "scalar" route writes
//    the same values as 4-byte streaming stores. The grid is sized to about
//    3 072 blocks (a dozen waves of the two blocks an SM holds) by the run
//    length. The stores run under the build: what bounds this design is the
//    build's issue rate, not the write stream (16 rows a thread ran faster
//    than 8, at two blocks an SM instead of three).
//  * "tiled" (d above 64): a 2-D grid of 64 x 64 output tiles on the shared
//    `gram_tile` (../csrc/gram_tile.cuh), 4-byte stores.
// Each value's arithmetic is gram_tile's: x.z by fmaf over the features in
// order 0 .. d - 1 (bf16: operands rounded, accumulated in fp32), the norms
// in fp32 from the unrounded operands, max(xn + zn - 2 x.z, 0), then
// family_epilogue. With z = x both norms come from the same launch, so K_MM
// is symmetric bit for bit. The ragged edges (n, m, d) are masked in the
// kernels; nothing is padded.
#include "cp_async.cuh"
#include "gram_tile.cuh"
#include "launchers.h"
#include "tile_epilogue.cuh"

using namespace repro;

namespace {

__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ x, const float* __restrict__ z, float* __restrict__ out,
            int n, int m, int d, int fam, float s, int bf16) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.x * TILE, col0 = blockIdx.y * TILE;
  float g[PER][PER];
  gram_tile(x, n, row0, z, m, col0, d, fam, s, bf16 != 0, sm, g);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < m) out[(long long)r * m + c] = g[i][j];
    }
  }
}

constexpr int GW_THREADS = 256;                    // 8 warps
constexpr int GW_RW = 16;                          // rows per warp and thread
constexpr int GW_ROWS = GW_RW * GW_THREADS / 32;   // rows per stripe (128)
constexpr int GW_CW = 4;                           // columns per thread: one float4
constexpr int GW_COLS = 32 * GW_CW;                // columns per Z tile (128)
constexpr int GW_DMAX = 64;                        // largest d the route takes
constexpr int GW_XS = GW_ROWS + 4;                 // stripe stride: 16-byte rows
constexpr int GW_ZS = GW_COLS + 4;                 // tile stride: 16-byte rows

// Offsets (in floats) into the block's dynamic shared memory for d features;
// every region starts on a 16-byte boundary.
struct GramLayout {
  int xs, xn, zs, zn, total;
};

__host__ __device__ inline GramLayout gram_layout(int d) {
  GramLayout l;
  l.xs = 0;                      // [d][GW_XS]     the stripe's rows, feature-major
  l.xn = l.xs + d * GW_XS;       // [GW_ROWS]      their squared norms
  l.zs = l.xn + GW_ROWS;         // [2][d][GW_ZS]  two Z tiles, feature-major
  l.zn = l.zs + 2 * d * GW_ZS;   // [2][GW_COLS]   their squared norms
  l.total = l.zn + 2 * GW_COLS;
  return l;
}

// fn(r, f, e) for element e = r d + f of a (rows, d) block, e = tid, tid +
// GW_THREADS, ...: the rows and features stepped without a division per
// element. Each thread visits the same elements of every block (the BF16
// rounding pass relies on it: a thread sees its own cp.async data after its
// wait, before the barrier).
template <typename F>
__device__ __forceinline__ void for_each_element(int rows, int d, int tid, F fn) {
  const int dr = GW_THREADS / d, df = GW_THREADS - dr * d;
  int r = tid / d, f = tid - r * d;
  for (int e = tid; e < rows * d; e += GW_THREADS) {
    fn(r, f, e);
    r += dr;
    f += df;
    if (f >= d) f -= d, ++r;
  }
}

// N (a multiple of 4) consecutive floats of shared memory, 16-byte aligned,
// to registers as float4 loads.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  static_assert(N % 4 == 0, "whole float4");
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + q);
    v[q] = t.x, v[q + 1] = t.y, v[q + 2] = t.z, v[q + 3] = t.w;
  }
}

// out[row0 .. row0 + 128, tiles t0 .. t1 of 128 columns] = k(x, z); the
// stripe from blockIdx.x, the run of `run` tiles from blockIdx.y. VEC: m % 4
// == 0 and the rows go out as 16-byte stores.
template <bool VEC, bool BF16>
__global__ void __launch_bounds__(GW_THREADS)
gram_wide_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ xnorm, const float* __restrict__ znorm,
                 float* __restrict__ out, int n, int m, int d, int run, int fam, float s) {
  extern __shared__ __align__(16) float dyn[];
  const GramLayout L = gram_layout(d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * GW_ROWS, rows = min(GW_ROWS, n - row0);
  const int t0 = blockIdx.y * run, t1 = min((m + GW_COLS - 1) / GW_COLS, t0 + run);
  float* xs = dyn + L.xs;

  // The stripe (rows past n as zeros), committed with the first tile.
  {
    const float* src = x + static_cast<long long>(row0) * d;
    for_each_element(GW_ROWS, d, tid, [&](int r, int f, int e) {
      cp_async4(xs + f * GW_XS + r, src + (r < rows ? e : 0), r < rows ? 4 : 0);
    });
    if (tid < GW_ROWS)
      cp_async4(dyn + L.xn + tid, xnorm + row0 + (tid < rows ? tid : 0), tid < rows ? 4 : 0);
  }
  // Tile t into buffer b: z feature-major and its norms; columns past m as zeros.
  auto stage = [&](int t, int b) {
    const int c0 = t * GW_COLS, cols = min(GW_COLS, m - c0);
    float* zs = dyn + L.zs + b * d * GW_ZS;
    const float* src = z + static_cast<long long>(c0) * d;
    for_each_element(GW_COLS, d, tid, [&](int c, int f, int e) {
      cp_async4(zs + f * GW_ZS + c, src + (c < cols ? e : 0), c < cols ? 4 : 0);
    });
    if (tid < GW_COLS)
      cp_async4(dyn + L.zn + b * GW_COLS + tid, znorm + c0 + (tid < cols ? tid : 0),
                tid < cols ? 4 : 0);
    cp_async_commit();
  };

  stage(t0, 0);
  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) & 1;
    const bool next = t + 1 < t1;
    if (next) stage(t + 1, b ^ 1);  // the other buffer, free since the last barrier
    if (next)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    float* zs = dyn + L.zs + b * d * GW_ZS;
    if constexpr (BF16) {  // the cross term's operands rounded, the norms not
      if (t == t0)
        for_each_element(GW_ROWS, d, tid, [&](int r, int f, int) {
          xs[f * GW_XS + r] = round_bf16(xs[f * GW_XS + r]);
        });
      for_each_element(GW_COLS, d, tid, [&](int c, int f, int) {
        zs[f * GW_ZS + c] = round_bf16(zs[f * GW_ZS + c]);
      });
    }
    __syncthreads();

    float g[GW_RW][GW_CW];
#pragma unroll
    for (int i = 0; i < GW_RW; ++i)
#pragma unroll
      for (int j = 0; j < GW_CW; ++j) g[i][j] = 0.0f;
    const float* xa = xs + GW_RW * warp;
    const float* zb = zs + GW_CW * lane;
#pragma unroll 4
    for (int f = 0; f < d; ++f) {
      float a[GW_RW], bv[GW_CW];
      load_vec(xa + f * GW_XS, a);
      load_vec(zb + f * GW_ZS, bv);
#pragma unroll
      for (int i = 0; i < GW_RW; ++i)
#pragma unroll
        for (int j = 0; j < GW_CW; ++j) g[i][j] = fmaf(a[i], bv[j], g[i][j]);
    }
    float xni[GW_RW], znj[GW_CW];
    load_vec(dyn + L.xn + GW_RW * warp, xni);
    load_vec(dyn + L.zn + b * GW_COLS + GW_CW * lane, znj);
    tile_epilogue(fam, g, xni, znj, s);

    const int c = t * GW_COLS + GW_CW * lane;
#pragma unroll
    for (int i = 0; i < GW_RW; ++i) {
      const int r = GW_RW * warp + i;
      if (r >= rows) break;
      float* dst = out + static_cast<long long>(row0 + r) * m + c;
      if constexpr (VEC) {
        if (c < m) __stcs(reinterpret_cast<float4*>(dst), make_float4(g[i][0], g[i][1], g[i][2],
                                                                      g[i][3]));
      } else {
#pragma unroll
        for (int j = 0; j < GW_CW; ++j)
          if (c + j < m) __stcs(dst + j, g[i][j]);
      }
    }
    __syncthreads();  // buffer b is free for the tile after next
  }
}

template <bool VEC, bool BF16>
void launch_wide(const float* x, const float* z, const float* xnorm, const float* znorm,
                 float* out, int n, int m, int d, int run, int fam, float s, cudaStream_t st) {
  const auto kernel = gram_wide_kernel<VEC, BF16>;
  const int smem = gram_layout(d).total * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tiles = (m + GW_COLS - 1) / GW_COLS;
  const dim3 grid((n + GW_ROWS - 1) / GW_ROWS, (tiles + run - 1) / run);
  kernel<<<grid, GW_THREADS, smem, st>>>(x, z, xnorm, znorm, out, n, m, d, run, fam, s);
}

}  // namespace

// n, m >= 1 (the binding returns before launching an empty grid).
void repro::launch_gram(const float* x, const float* z, float* out, int n, int m, int d,
                        int fam, float s, bool bf16, cudaStream_t st) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  gram_kernel<<<grid, THREADS, 0, st>>>(x, z, out, n, m, d, fam, s, bf16);
}

void repro::launch_gram_wide(const float* x, const float* z, const float* xnorm,
                             const float* znorm, float* out, int n, int m, int d, int run,
                             bool vec, int fam, float s, bool bf16, cudaStream_t st) {
  const auto launch = vec ? (bf16 ? launch_wide<true, true> : launch_wide<true, false>)
                          : (bf16 ? launch_wide<false, true> : launch_wide<false, false>);
  launch(x, z, xnorm, znorm, out, n, m, d, run, fam, s, st);
}

long long repro::gram_wide_smem_floats(int d) { return gram_layout(d).total; }
