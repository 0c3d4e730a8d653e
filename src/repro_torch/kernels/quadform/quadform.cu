// K6: the fused leverage-score quadratic form s_i = rowsum((G W) * G) on
// Hopper (sm_90a), hand-written CUDA C++. G W is never written to device
// memory.
//
// Replaces: src/repro/kernels/quadform/quadform.py:51 `quadform_pallas`
// (grid (i, k, j) with the (bn, bk) slab of G W accumulated in VMEM over j,
// multiplied by G[i, k-tile] and row-reduced into an output block revisited
// across k, which a sequential TPU grid allows).
//
// What bounds it on this card: operations. At the predictive-variance shape
// (n = 10^5 rows, m = 10^4 centers) it reads G (4 GB) and W (0.4 GB) once,
// 1.3 ms at 3.35 TB/s, but does 2 n m^2 = 2e13 fp32 FLOPs, 300 ms at the
// 67 TFLOP/s fp32 peak. It stays on the FMA units in IEEE fp32 (no TF32).
//
// Design, register-tiled as an SGEMM: block (row tile, W column tile) forms
// acc (128 x 128) = G[rows, :] W[:, k-tile] with 256 threads, each holding
// 8 x 8 outputs in registers: rows tr + 16 i and columns 4 tc + c, 64 + 4 tc
// + c. G and W stream 16 deep through a 2-stage shared-memory ring filled
// by cp.async, so the loads of step j + 1 overlap the FMAs of step j. G
// keeps its row-major layout in shared memory (cp.async copies it as it
// lies; rows padded by 4 floats; a k-major copy through 4-byte cp.async ran
// slower): a thread reads 4 depths of one row as a float4, and W's 4
// neighbouring columns as a float4, so 16 LDS.128 feed 256 FMAs, without
// bank conflicts. The launch bounds leave the register count free (one
// block of 8 warps per SM, no spills): capped at 128 for two blocks per SM,
// the 64 accumulators and 40 fragment values spilled and ran slower. Ragged
// tiles are zero-filled at staging (cp.async with a zero source size); the
// FMA loop has no bounds checks. m % 4 == 0 with 16-byte aligned G and W
// copies 16 bytes at a time, else 4. `BF16` is a template parameter: its
// kernel rounds the fragments of the G W product to bf16 (fp32
// accumulation), the fp32 kernel carries no branch. Blocks walk the column
// tiles of one row tile before the next, so the blocks resident at once
// share G's row tile; a raster grouping several row tiles ran no faster
// (the FMA pipe bounds the kernel, not L2 traffic).
//
// The epilogue multiplies acc by G[rows, k-tile] (fp32, unrounded) and sums
// each row over the tile in a fixed order: the thread's 8 columns, then the
// 8 lanes of its row (a butterfly), then the two warps that hold the row.
// Hopper blocks run in no order, so the k-tiles cannot add into one output
// as the TPU grid does: each writes its per-row partial to partial[k-tile,
// row], and the `reduce_partials` kernel of falkon_matvec.cu adds the
// k-tiles in index order. No float atomics: the result is bit-repeatable.
#include <cstdint>

#include "cp_async.cuh"
#include "gram_tile.cuh"
#include "launchers.h"

using repro::cp_async16;
using repro::cp_async4;
using repro::round_bf16;

namespace {

constexpr int QT = 128;        // rows of G and columns of W per block
constexpr int QK = 16;         // depth (G columns / W rows) per stage
constexpr int QTHREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int GLD = QK + 4;    // floats per shared row of the G tile

struct Stage {
  float g[QT][GLD];  // G[rows, j-chunk], row-major
  float w[QK][QT];   // W[j-chunk, k-tile]
};

// G[row0.., j0..j0 + QK) and W[j0..j0 + QK, col0..) into one stage, zeros
// past n and m. VEC: 4-float chunks (m % 4 == 0, so a chunk is all in or
// all out), 2 per thread for each matrix; else one float per copy, 8 each.
template <bool VEC>
__device__ __forceinline__ void stage(Stage& sm, const float* __restrict__ g,
                                      const float* __restrict__ w, int n, int m, int row0,
                                      int col0, int j0, int tid) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < QT * QK / 4 / QTHREADS; ++q) {
      const int e = tid + QTHREADS * q;
      const int gr = e / (QK / 4), gc = e % (QK / 4) * 4;
      const bool gin = row0 + gr < n && j0 + gc < m;
      cp_async16(&sm.g[gr][gc], gin ? g + (long long)(row0 + gr) * m + j0 + gc : g,
                 gin ? 16 : 0);
      const int wr = e / (QT / 4), wc = e % (QT / 4) * 4;
      const bool win = j0 + wr < m && col0 + wc < m;
      cp_async16(&sm.w[wr][wc], win ? w + (long long)(j0 + wr) * m + col0 + wc : w,
                 win ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int q = 0; q < QT * QK / QTHREADS; ++q) {
      const int e = tid + QTHREADS * q;
      const int gr = e / QK, gc = e % QK;
      const bool gin = row0 + gr < n && j0 + gc < m;
      cp_async4(&sm.g[gr][gc], gin ? g + (long long)(row0 + gr) * m + j0 + gc : g, gin ? 4 : 0);
      const int wr = e / QT, wc = e % QT;
      const bool win = j0 + wr < m && col0 + wc < m;
      cp_async4(&sm.w[wr][wc], win ? w + (long long)(j0 + wr) * m + col0 + wc : w, win ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// partial[k-tile, row] = sum over the k-tile's W columns k of (G[row, :]
// W[:, k]) G[row, k]. Grid: one block per (row tile, W column tile), 1-D.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(QTHREADS)
quadform_partial_kernel(const float* __restrict__ g, const float* __restrict__ w,
                        float* __restrict__ partial, int n, int m) {
  __shared__ __align__(16) Stage sm[2];
  __shared__ float red[2][QT];
  const int tiles_c = (m + QT - 1) / QT;
  const int row0 = blockIdx.x / tiles_c * QT, ct = blockIdx.x % tiles_c, col0 = ct * QT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = lane / 8 + 4 * (warp / 2);  // rows tr + 16 i
  const int tc = lane % 8 + 8 * (warp % 2);  // columns 4 tc + c and 64 + 4 tc + c
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nt = (m + QK - 1) / QK;
  stage<VEC>(sm[0], g, w, n, m, row0, col0, 0, tid);
  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt)  // into the stage freed at the end of it - 1
      stage<VEC>(sm[(it + 1) & 1], g, w, n, m, row0, col0, (it + 1) * QK, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // step it has landed
    __syncthreads();
    const Stage& s = sm[it & 1];
#pragma unroll
    for (int kq = 0; kq < QK; kq += 4) {
      float4 a4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a4[i] = *reinterpret_cast<const float4*>(&s.g[tr + 16 * i][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&s.w[kq + kk][4 * tc]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s.w[kq + kk][64 + 4 * tc]);
        float a[8], b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = lane_of(a4[i], kk);
        if (BF16) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            a[i] = round_bf16(a[i]);
            b[i] = round_bf16(b[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // stage it & 1 is consumed: step it + 2 may overwrite it
  }

  // Epilogue: row r's share of this k-tile over the thread's 8 columns, then
  // the 8 lanes that share tr (lanes 8 p.. of the warp), then the two warps.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + tr + 16 * i;
    float part = 0.0f;
    if (r < n) {
      const float* gr = g + (long long)r * m + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j < 4 ? 4 * tc + j : 64 + 4 * tc + j - 4;
        if (col0 + c < m) part = fmaf(acc[i][j], gr[c], part);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off *= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane % 8 == 0) red[warp % 2][tr + 16 * i] = part;
  }
  __syncthreads();
  if (tid < QT && row0 + tid < n)
    partial[(long long)ct * n + row0 + tid] = red[0][tid] + red[1][tid];
}

template <bool BF16, bool VEC>
void launch(const float* g, const float* w, float* partial, int n, int m, cudaStream_t st) {
  const int tiles = ((n + QT - 1) / QT) * ((m + QT - 1) / QT);
  quadform_partial_kernel<BF16, VEC><<<tiles, QTHREADS, 0, st>>>(g, w, partial, n, m);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// n, m >= 1 (the wrapper returns zeros before launching an empty grid).
void repro::launch_quadform_partial(const float* g, const float* w, float* partial, int n,
                                    int m, bool bf16, cudaStream_t st) {
  const bool vec = m % 4 == 0 && aligned16(g) && aligned16(w);
  if (bf16)
    vec ? launch<true, true>(g, w, partial, n, m, st)
        : launch<true, false>(g, w, partial, n, m, st);
  else
    vec ? launch<false, true>(g, w, partial, n, m, st)
        : launch<false, false>(g, w, partial, n, m, st);
}
