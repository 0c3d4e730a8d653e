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
// M = 1024) cannot stay resident as it does in VMEM. One block of 256
// threads owns BN = 32 candidate rows:
//  1. it builds their (32, M) Gram slab with the shared `gram_tile`
//     (../csrc/gram_tile.cuh) into dynamic shared memory (133 KB at
//     M = 1024) and zeroes the invalid center columns with zmask, as
//     rls_score.py:55 does (the padded rows of W are the identity);
//  2. it streams W through shared memory in (32 x 64) tiles: for each
//     64-column tile of W it forms acc (32 x 64) = G W[:, tile] with fp32
//     FMA (each thread a 2 x 4 sub-block in registers) and adds
//     rowsum(acc * G[:, tile]) to each row's running sum, tiles in order;
//  3. the 16 lanes that hold a row add their sums in a fixed butterfly and
//     the epilogue writes (kdiag - quad) / lam n. lam n is a kernel
//     argument, so the whole ladder runs one compiled kernel.
// Each row belongs to one block: no cross-block sum, no atomics, and the
// result is bit-repeatable. Ragged R, M and d are masked in the kernel
// (gram_tile returns 0 outside the valid range; W is read only inside
// [0, M)). With bf16, only the operands of x . z and of G W are rounded;
// the norms, the accumulation, the product with G and the epilogue stay
// fp32 (rls_score.py:44,56-57). The Gram slab is built as 64-row tiles of
// which the block keeps 32: the Gram work is ~2 % of the G W work at
// M = 1024, so the waste is small where the time is.
#include "gram_tile.cuh"
#include "launchers.h"

using namespace repro;

namespace {

constexpr int BN = 32;           // candidate rows per block
constexpr int WJ = 32;           // W rows per streamed tile
constexpr int WK = 64;           // W columns per streamed tile
constexpr int GPAD = 16;         // Gram-slab row padding (conflict-free row pairs)
constexpr int RPT = BN / 16;     // rows per thread (2)
constexpr int CPT = WK / 16;     // columns per thread (4)

__global__ void __launch_bounds__(THREADS)
rls_score_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ w, const float* __restrict__ zmask,
                 const float* __restrict__ kdiag, float* __restrict__ out, int n, int m,
                 int mpad, int d, int fam, float s, float lamn, int bf16) {
  extern __shared__ float dyn[];
  const int gstride = mpad + GPAD;
  float* gs = dyn;                   // [BN][gstride]: the masked Gram slab
  float* ws = dyn + BN * gstride;    // [WJ][WK]: the current W tile
  __shared__ TileSmem sm;
  const int row0 = blockIdx.x * BN;
  const int rend = min(n, row0 + BN);  // the block's rows are [row0, rend)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // 1. Gram slab. gram_tile covers 64 rows; rows >= rend come back as 0 and
  //    only the first BN are kept.
  for (int col0 = 0; col0 < mpad; col0 += TILE) {
    float g[PER][PER];
    gram_tile(x, rend, row0, z, m, col0, d, fam, s, bf16 != 0, sm, g);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = ty + 16 * i;
      if (r >= BN) continue;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = col0 + tx + 16 * j;
        gs[r * gstride + c] = c < m ? g[i][j] * zmask[c] : 0.0f;
      }
    }
  }
  __syncthreads();

  // 2. quad_r = sum over W column tiles k of rowsum((G W[:, k]) * G[:, k]).
  float quad[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) quad[i] = 0.0f;
  for (int k0 = 0; k0 < m; k0 += WK) {
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[i][q] = 0.0f;
    for (int j0 = 0; j0 < m; j0 += WJ) {
#pragma unroll
      for (int e0 = 0; e0 < WJ * WK; e0 += THREADS) {
        const int e = e0 + tid;
        const int jj = e / WK, c = e % WK;
        float v = (j0 + jj < m && k0 + c < m) ? w[(long long)(j0 + jj) * m + k0 + c] : 0.0f;
        ws[jj * WK + c] = bf16 ? round_bf16(v) : v;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < WJ; ++jj) {
        float a[RPT], b[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float v = gs[(ty + 16 * i) * gstride + j0 + jj];
          a[i] = bf16 ? round_bf16(v) : v;
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) b[q] = ws[jj * WK + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = k0 + tx + 16 * q;
        if (c < m) quad[i] = fmaf(acc[i][q], gs[(ty + 16 * i) * gstride + c], quad[i]);
      }
  }

  // 3. The 16 lanes of a half-warp share ty: a fixed butterfly adds their
  //    sums, then one lane writes the score.
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float v = quad[i];
#pragma unroll
    for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < n) out[r] = (kdiag[r] - v) / lamn;
  }
}

}  // namespace

// n >= 1, 0 <= m <= 1024 (the wrapper refuses larger center buffers: the
// slab would not fit in shared memory).
void repro::launch_rls_score(const float* x, const float* z, const float* w,
                             const float* zmask, const float* kdiag, float* out, int n, int m,
                             int d, int fam, float s, float lamn, bool bf16, cudaStream_t st) {
  const int mpad = (m + TILE - 1) / TILE * TILE;
  const int smem = static_cast<int>((BN * (mpad + GPAD) + WJ * WK) * sizeof(float));
  cudaFuncSetAttribute(rls_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rls_score_kernel<<<(n + BN - 1) / BN, THREADS, smem, st>>>(x, z, w, zmask, kdiag, out, n, m,
                                                             mpad, d, fam, s, lamn, bf16);
}
