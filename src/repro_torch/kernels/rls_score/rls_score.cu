// K5: the fused Eq. 3 RLS score on Hopper (sm_90a), hand-written CUDA C++:
//
//   score_i = (K_ii - g_i^T W g_i) / (lam n),   g_i = k(x_i, z) * zmask
//
// Replaces: src/repro/kernels/rls_score/rls_score.py:65 `rls_score_pallas`
// (Gram tile -> G W -> score epilogue in one dispatch, with z, the (M, M)
// inverse W and the (bn, M) Gram tile resident in VMEM).
//
// What bounds it on this card: operations. Per candidate row it builds M
// Gram values (2d + 5 operations each) and contracts them against W (2 M^2
// FLOPs), so at M = 1024 the G W product is ~50x the Gram work; the bytes
// are x, z, W (4 MB at M = 1024), kdiag and the scores, each read or written
// once. At R = 3e4 candidates and M = 1024: 6.4e10 FLOPs, ~1 ms at the
// 67 TFLOP/s fp32 peak, against ~2 us of bytes.
//
// Design. A block has at most 227 KB of shared memory, so W (4 MB at
// M = 1024) cannot stay resident as it does in VMEM; the Gram rows can. A
// block of 256 threads owns 32 candidate rows and two 128-column tiles of W
// (at the ladder's (6 144, 640): 576 blocks, two per SM):
//  1. it builds the masked Gram slab G[rows, 0:M] * zmask of its rows into
//     shared memory (132 KB at M = 1024), 128 centers per pass, x and z
//     staged as stored, 32 features a stage; each thread a 4 x 4 register
//     tile, a warp over 16 rows x 32 centers (one wavefront per fragment
//     load), the norms from the same unrounded values (no separate pass);
//     G is never written to device memory. The slab serves both column
//     tiles; the Gram work is ~1 / (0.5 M / (2d + 5)) of the G W work;
//  2. per column tile, it forms acc (32 x 128) = G W[:, tile] with K6's
//     kind of main loop, the depth split between two halves of 4 warps
//     (each its own 3-stage cp.async ring of 8-row W stages, one named
//     barrier per stage; 16-byte copies when M % 4 == 0 and W is aligned,
//     else 4-byte, zero-filled past M): each thread an 8 x 4 register
//     tile, float4 fragments of G (4 depths of a row) and W, a warp over 4
//     consecutive rows x 8 column quads so that both fragment loads are one
//     wavefront (the slab's row stride is 4 mod 8 floats): 12 LDS.128 per
//     128 FMAs. `BF16` is a template parameter: its kernel rounds the
//     fragments of x . z and of G W; the fp32 kernel carries no branch;
//  3. adds the second half's acc to the first's, multiplies by G[rows,
//     tile] (fp32, unrounded) and sums each row over the tile in a fixed
//     order (the thread's 4 columns, a butterfly over the row's 8 lanes,
//     then the 4 warps in order) into partial[tile, row].
// A second kernel adds the k-tiles in index order and writes
// (K_ii - sum) / lam n, K_ii from the family's diagonal; lam n is an
// argument, so the whole ladder runs one compiled kernel. No float atomics:
// the result is bit-repeatable. Ragged R, M and d are masked in the kernel.
// With bf16, only the operands of x . z and of G W are rounded
// (rls_score.py:44,56-57).
#include <cstdint>

#include "cp_async.cuh"
#include "gram_tile.cuh"
#include "launchers.h"
#include "tile_epilogue.cuh"

using namespace repro;

namespace {

constexpr int SR = 32;         // candidate rows per block
constexpr int SN = 128;        // W columns per block, centers per build pass
constexpr int SK = 8;          // W rows per ring stage
constexpr int SDK = 32;        // features per build stage
constexpr int STHREADS = 256;  // two halves of 4 warps (8 x 4 register tiles in G W)
constexpr int HALF = STHREADS / 2;
constexpr int SSTAGES = 3;     // W stages in flight, per half
constexpr int SCT = 2;         // W column tiles per block, one slab build for all
constexpr int XLD = SR + 4;    // floats per shared row of the staged x
constexpr int ZLD = SN + 4;    // floats per shared row of the staged z

struct WStage {
  float w[SK][SN];  // W[j-chunk, k-tile]
};

// The two halves' W rings of the G W product and, before them, the x and z
// stages of the slab build; after them, one half's accumulators for the
// other: never live at once.
union Ring {
  WStage st[2][SSTAGES];
  struct {
    float zs[SDK][ZLD];  // z[pass centers, feature chunk], feature-major
    float xs[SDK][XLD];  // x[rows, feature chunk], feature-major
  } b;
  float acc[32][HALF];   // the second half's acc[i][j] at [4 i + j][thread]
};

// W[j0..j0 + SK, col0..col0 + SN) into one stage by the HALF threads of a
// half, zeros past m. VEC: 16-byte chunks (m % 4 == 0, so a chunk is all in
// or all out), 2 per thread; else one float per copy, 8 per thread.
template <bool VEC>
__device__ __forceinline__ void stage_w(WStage& st, const float* __restrict__ w, int m,
                                        int col0, int j0, int t) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < SK * SN / 4 / HALF; ++q) {
      const int e = t + HALF * q;
      const int r = e / (SN / 4), c = e % (SN / 4) * 4;
      const bool in = j0 + r < m && col0 + c < m;
      cp_async16(&st.w[r][c], in ? w + (long long)(j0 + r) * m + col0 + c : w, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int q = 0; q < SK * SN / HALF; ++q) {
      const int e = t + HALF * q;
      const int r = e / SN, c = e % SN;
      const bool in = j0 + r < m && col0 + c < m;
      cp_async4(&st.w[r][c], in ? w + (long long)(j0 + r) * m + col0 + c : w, in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// The HALF threads of half h (named barrier 1 + h) wait for each other.
__device__ __forceinline__ void half_sync(int h) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "n"(HALF) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// partial[k-tile, row] = sum over the k-tile's W columns k of (G[row, :]
// W[:, k]) G[row, k], G = k(x, z) * zmask. Grid: one block per (row tile,
// SCT W column tiles), 1-D; dynamic shared memory: the slab [SR][gstride],
// gstride = the k-tiles times SN, plus 4.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(STHREADS)
rls_score_partial_kernel(const float* __restrict__ x, const float* __restrict__ z,
                         const float* __restrict__ w, const float* __restrict__ zmask,
                         float* __restrict__ partial, int n, int m, int d, int gstride, int fam,
                         float s) {
  extern __shared__ __align__(16) float dyn[];
  float* gs = dyn;  // [SR][gstride]: the masked Gram slab
  __shared__ __align__(16) Ring ring;
  __shared__ float red[4][SR];
  auto& xs = ring.b.xs;
  const int tiles_c = gstride / SN;  // gstride - 4 is a multiple of SN
  const int groups = (tiles_c + SCT - 1) / SCT;
  const int row0 = blockIdx.x / groups * SR, ct0 = blockIdx.x % groups * SCT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lr = lane / 8, lc = lane % 8;

  // 1. The slab, SN centers per pass, by all threads: warp (wr, wc) spans
  //    rows 16 wr.. and columns 32 wc.., lane (lr, lc) a 4 x 4 register tile
  //    of rows r0 + i and columns c0 + j. x (once, if d <= SDK) and z are
  //    staged as stored, SDK features a stage (a stage's flat index is split
  //    by a float reciprocal, exact below 2^12 elements); each thread
  //    accumulates x . z and, from the same unrounded values, its rows'
  //    (first pass) and columns' squared norms; bf16 rounds the x . z
  //    operands only.
  {
    const int r0 = 16 * (warp / 4) + 4 * lr, c0 = 32 * (warp % 4) + 4 * lc;
    float xn[4] = {};
    for (int p0 = 0; p0 < tiles_c * SN; p0 += SN) {
      float g[4][4] = {}, zn[4] = {}, zm[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) zm[j] = p0 + c0 + j < m ? zmask[p0 + c0 + j] : 0.0f;
      for (int f0 = 0; f0 < d; f0 += SDK) {
        const int fw = min(SDK, d - f0);
        const float inv_fw = 1.0f / static_cast<float>(fw);
        __syncthreads();  // the previous stage's readers are done
        if (p0 == 0 || d > SDK) {  // with d <= SDK the first x stage serves every pass
          for (int e = tid; e < SR * fw; e += STHREADS) {
            const int r = __float2int_rz((e + 0.5f) * inv_fw), f = e - r * fw;
            xs[f][r] = row0 + r < n ? x[(long long)(row0 + r) * d + f0 + f] : 0.0f;
          }
        }
        for (int e = tid; e < SN * fw; e += STHREADS) {
          const int c = __float2int_rz((e + 0.5f) * inv_fw), f = e - c * fw;
          ring.b.zs[f][c] = p0 + c < m ? z[(long long)(p0 + c) * d + f0 + f] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int f = 0; f < fw; ++f) {
          const float4 a4 = *reinterpret_cast<const float4*>(&xs[f][r0]);
          const float4 b4 = *reinterpret_cast<const float4*>(&ring.b.zs[f][c0]);
          float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
          if (p0 == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) xn[i] = fmaf(a[i], a[i], xn[i]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) zn[j] = fmaf(b[j], b[j], zn[j]);
          if (BF16) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[i] = round_bf16(a[i]);
              b[i] = round_bf16(b[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
        }
      }
      tile_epilogue(fam, g, xn, zn, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = row0 + r0 + i < n;
        *reinterpret_cast<float4*>(gs + (r0 + i) * gstride + p0 + c0) =
            make_float4(in ? g[i][0] * zm[0] : 0.0f, in ? g[i][1] * zm[1] : 0.0f,
                        in ? g[i][2] * zm[2] : 0.0f, in ? g[i][3] * zm[3] : 0.0f);
      }
    }
  }
  __syncthreads();  // the slab is whole; the ring's x and z stages are free

  // 2. acc = G[rows, :] W[:, k-tile], the depth split between the two halves
  //    (half h: W row stages [h nt0, min(nt, (h + 1) nt0))), each with its own
  //    ring and named barrier. In a half, warp hw and lane (lr, lc) hold rows
  //    lr + 4 i and columns gc + j, gc = 32 hw + 4 lc: a G fragment load
  //    reads 4 consecutive rows (disjoint banks, as gstride % 8 == 4), a W
  //    fragment load 8 neighbouring float4s, one wavefront each: 12 LDS.128
  //    per 128 FMAs.
  const int h = warp / 4, t = tid % HALF, gc = 32 * (warp % 4) + 4 * lc;
  const int nt = (m + SK - 1) / SK, nt0 = (nt + 1) / 2;
  const int it0 = h * nt0, it1 = min(nt, it0 + nt0);
  for (int ct = ct0; ct < min(tiles_c, ct0 + SCT); ++ct) {
    const int col0 = ct * SN;
    float acc[8][4] = {};
#pragma unroll
    for (int q = 0; q < SSTAGES - 1; ++q) {  // steps it0 .. it0 + SSTAGES - 2 in flight
      if (it0 + q < it1)
        stage_w<VEC>(ring.st[h][q], w, m, col0, (it0 + q) * SK, t);
      else
        cp_async_commit();
    }
    for (int it = it0; it < it1; ++it) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(SSTAGES - 2) : "memory");  // step it landed
      half_sync(h);  // ... for every thread of the half, which is also done with step it - 1
      const int ahead = it + SSTAGES - 1;  // into the stage of step it - 1
      if (ahead < it1)
        stage_w<VEC>(ring.st[h][(ahead - it0) % SSTAGES], w, m, col0, ahead * SK, t);
      else
        cp_async_commit();
      const WStage& st = ring.st[h][(it - it0) % SSTAGES];
      const float* ga = gs + lr * gstride + it * SK;
#pragma unroll
      for (int kq = 0; kq < SK; kq += 4) {
        float4 a4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a4[i] = *reinterpret_cast<const float4*>(ga + 4 * i * gstride + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b4 = *reinterpret_cast<const float4*>(&st.w[kq + kk][gc]);
          float a[8], b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = lane_of(a4[i], kk);
          if (BF16) {
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = round_bf16(a[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = round_bf16(b[j]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // both halves are done with their rings

    // 3. The second half's acc added to the first's (first + second), then
    //    row r's share of this k-tile: the thread's 4 columns (G past m is 0),
    //    a butterfly over the 8 lanes of the row, then the 4 warps in order.
    if (h == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ring.acc[4 * i + j][t] = acc[i][j];
    }
    __syncthreads();
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = lr + 4 * i;
        const float4 g4 = *reinterpret_cast<const float4*>(gs + r * gstride + col0 + gc);
        float part = (acc[i][0] + ring.acc[4 * i][t]) * g4.x;
        part = fmaf(acc[i][1] + ring.acc[4 * i + 1][t], g4.y, part);
        part = fmaf(acc[i][2] + ring.acc[4 * i + 2][t], g4.z, part);
        part = fmaf(acc[i][3] + ring.acc[4 * i + 3][t], g4.w, part);
#pragma unroll
        for (int off = 1; off < 8; off *= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lc == 0) red[warp][r] = part;
      }
    }
    __syncthreads();
    if (tid < SR && row0 + tid < n)
      partial[(long long)ct * n + row0 + tid] =
          ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
    __syncthreads();  // red and the ring are free for the next column tile
  }
}

// out[i] = (K_ii - sum over tiles, in index order, of partial[tile, i]) / lamn,
// K_ii the family's epilogue of 0 (distance families) or of |x_i|^2 (the
// linear family), as families.diag_pre gives it.
__global__ void rls_score_finish_kernel(const float* __restrict__ partial,
                                        const float* __restrict__ x, float* __restrict__ out,
                                        int n, int d, int n_tiles, int fam, float s, float lamn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float pre = 0.0f;
  if (fam == LINEAR) {
    const float* xr = x + (long long)i * d;
    for (int f = 0; f < d; ++f) pre = fmaf(xr[f], xr[f], pre);
  }
  float quad = 0.0f;
  for (int t = 0; t < n_tiles; ++t) quad += partial[(long long)t * n + i];
  out[i] = (family_epilogue(fam, pre, s) - quad) / lamn;
}

template <bool BF16, bool VEC>
void launch(const float* x, const float* z, const float* w, const float* zmask, float* partial,
            int n, int m, int d, int fam, float s, cudaStream_t st) {
  const int tiles_c = max(1, (m + SN - 1) / SN);
  const int gstride = tiles_c * SN + 4;  // % 8 == 4: a fragment's 4 rows in disjoint banks
  const int smem = SR * gstride * static_cast<int>(sizeof(float));
  const auto kernel = rls_score_partial_kernel<BF16, VEC>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = (n + SR - 1) / SR * ((tiles_c + SCT - 1) / SCT);
  kernel<<<blocks, STHREADS, smem, st>>>(x, z, w, zmask, partial, n, m, d, gstride, fam, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// n >= 1, 0 <= m <= 1024 (the wrapper refuses larger center buffers: the
// slab would not fit in shared memory).
void repro::launch_rls_score_partial(const float* x, const float* z, const float* w,
                                     const float* zmask, float* partial, int n, int m, int d,
                                     int fam, float s, bool bf16, cudaStream_t st) {
  const bool vec = m % 4 == 0 && aligned16(w);
  if (bf16)
    vec ? launch<true, true>(x, z, w, zmask, partial, n, m, d, fam, s, st)
        : launch<true, false>(x, z, w, zmask, partial, n, m, d, fam, s, st);
  else
    vec ? launch<false, true>(x, z, w, zmask, partial, n, m, d, fam, s, st)
        : launch<false, false>(x, z, w, zmask, partial, n, m, d, fam, s, st);
}

void repro::launch_rls_score_finish(const float* partial, const float* x, float* out, int n,
                                    int d, int n_tiles, int fam, float s, float lamn,
                                    cudaStream_t st) {
  const int threads = 256;
  rls_score_finish_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
      partial, x, out, n, d, n_tiles, fam, s, lamn);
}
