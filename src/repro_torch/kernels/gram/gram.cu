// K1: dense Gram matrix K(X, Z) on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/gram/gram.py:45 `gram_pallas` (one VMEM tile per
// (bn, bm) output block, MXU matmul + VPU family epilogue).
//
// What bounds it on this card: the (n, m) fp32 output. At the main path's
// shape (K_MM, n = m = 10^4, d = 18) the kernel writes 400 MB and does
// ~2 n m d = 3.6 GFLOP, so the write stream (0.12 ms at 3.35 TB/s) is the
// bound, not the fp32 FMA rate (0.05 ms at 67 TFLOP/s).
//
// Design: a 2-D grid of 64 x 64 output tiles, one block each; the shared
// `gram_tile` (../csrc/gram_tile.cuh) stages X and Z through shared memory
// 8 features at a time and keeps the 4 x 4 outputs of each thread in
// registers until the epilogue, so every output is written exactly once and
// nothing else touches device memory. The ragged edges (n, m not multiples
// of 64, d not a multiple of 8) are masked in the kernel; nothing is padded.
#include "gram_tile.cuh"
#include "launchers.h"

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

}  // namespace

// n, m >= 1 (the binding returns before launching an empty grid).
void repro::launch_gram(const float* x, const float* z, float* out, int n, int m, int d,
                        int fam, float s, bool bf16, cudaStream_t st) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  gram_kernel<<<grid, THREADS, 0, st>>>(x, z, out, n, m, d, fam, s, bf16);
}
