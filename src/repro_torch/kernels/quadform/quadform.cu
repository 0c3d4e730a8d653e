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
// 67 TFLOP/s fp32 peak.
//
// Design: block (row tile, W column tile) forms acc (64 x 64) = G[rows, :]
// W[:, k-tile] on the fp32 FMA units, G and W staged through shared memory
// 16 columns at a time, each thread holding a 4 x 4 sub-block in registers;
// the epilogue multiplies acc by G[rows, k-tile] (fp32, unrounded) and sums
// each row over the tile in a fixed order. Hopper blocks run in no order,
// so the k-tiles cannot add into one output as the TPU grid does: each
// writes its per-row partial to partial[k-tile, row], and the
// `reduce_partials` kernel of falkon_matvec.cu adds the k-tiles in index
// order. No float atomics: the result is bit-repeatable. Ragged n and m are
// masked in the kernel; nothing is padded.
#include "gram_tile.cuh"
#include "launchers.h"

using repro::round_bf16;

namespace {

constexpr int QT = 64;        // rows of G and columns of W per block
constexpr int QK = 16;        // depth (G columns / W rows) staged per step
constexpr int QTHREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int QPER = 4;

// partial[blockIdx.y, row] = sum over the block's W columns k of
// (G[row, :] W[:, k]) G[row, k]. Grid: (row tiles, W column tiles).
__global__ void __launch_bounds__(QTHREADS)
quadform_partial_kernel(const float* __restrict__ g, const float* __restrict__ w,
                        float* __restrict__ partial, int n, int m, int bf16) {
  __shared__ float gs[QK][QT + 4];  // G[rows, j-chunk], transposed: gs[j][row]
  __shared__ float ws[QK][QT + 4];  // W[j-chunk, k-tile]: ws[j][col]
  const int row0 = blockIdx.x * QT, k0 = blockIdx.y * QT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[QPER][QPER];
#pragma unroll
  for (int i = 0; i < QPER; ++i)
#pragma unroll
    for (int j = 0; j < QPER; ++j) acc[i][j] = 0.0f;

  for (int j0 = 0; j0 < m; j0 += QK) {
#pragma unroll
    for (int q = 0; q < QT * QK / QTHREADS; ++q) {
      const int e = tid + QTHREADS * q;
      const int gr = e / QK, gc = e % QK;  // G: 16 neighbouring columns of a row
      const int wr = e / QT, wc = e % QT;  // W: 64 neighbouring columns of a row
      float gv = (row0 + gr < n && j0 + gc < m) ? g[(long long)(row0 + gr) * m + j0 + gc] : 0.0f;
      float wv = (j0 + wr < m && k0 + wc < m) ? w[(long long)(j0 + wr) * m + k0 + wc] : 0.0f;
      if (bf16) {
        gv = round_bf16(gv);
        wv = round_bf16(wv);
      }
      gs[gc][gr] = gv;
      ws[wr][wc] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < QK; ++jj) {
      float a[QPER], b[QPER];
#pragma unroll
      for (int i = 0; i < QPER; ++i) a[i] = gs[jj][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < QPER; ++j) b[j] = ws[jj][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < QPER; ++i)
#pragma unroll
        for (int j = 0; j < QPER; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: row r's share of this k-tile, summed over the thread's 4
  // columns, then over the 16 lanes that hold the row (a fixed butterfly
  // inside each half-warp: lanes 16 h + tx share ty).
#pragma unroll
  for (int i = 0; i < QPER; ++i) {
    const int r = row0 + ty + 16 * i;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < QPER; ++j) {
      const int c = k0 + tx + 16 * j;
      if (r < n && c < m) part = fmaf(acc[i][j], g[(long long)r * m + c], part);
    }
#pragma unroll
    for (int off = 8; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && r < n) partial[(long long)blockIdx.y * n + r] = part;
  }
}

}  // namespace

// n, m >= 1 (the wrapper returns zeros before launching an empty grid).
void repro::launch_quadform_partial(const float* g, const float* w, float* partial, int n,
                                    int m, bool bf16, cudaStream_t st) {
  const dim3 grid((n + QT - 1) / QT, (m + QT - 1) / QT);
  quadform_partial_kernel<<<grid, QTHREADS, 0, st>>>(g, w, partial, n, m, bf16);
}
