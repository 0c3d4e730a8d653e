// Shared Gram-tile device function for the hand-written Hopper kernels.
//
// Since the main paths' kernels build their Gram values in registers (K1's
// wide route, K2/K7's cluster route, K3's and K4's register routes, K5),
// `gram_tile` serves only the routes for wide features: K1's tiled route
// (d above 64) and K3's and K4's tiled routes (d above 32). The family ids,
// `family_epilogue` and `round_bf16` below are every kernel's.
//
// Counterpart of `_gram_tile` (src/repro/kernels/falkon_matvec/falkon_matvec.py)
// and `_gram_kernel` (src/repro/kernels/gram/gram.py): one block of 256 threads
// builds a TILE x TILE block of k(X, Z). The feature axis is staged through
// shared memory DK columns at a time; every thread owns a 4 x 4 sub-block held
// in registers (rows ty + 16 i, columns tx + 16 j, ty = tid / 16, tx = tid % 16).
//
// Arithmetic, in the reference's order:
//   prod = x . z               fp32 FMA (bf16: operands rounded to bf16 first,
//                              the product still accumulated in fp32)
//   xn, zn = row norms         fp32, from the unrounded operands
//   d2  = max(xn + zn - 2 prod, 0)
//   k   = epilogue(family, d2 or prod, inv_scale)   expf / sqrtf, no fast math
// Entries outside the valid n x m range come back as exactly 0, so callers can
// contract them against anything without masking again.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace repro {

constexpr int TILE = 64;      // rows of X and of Z in one Gram tile
constexpr int DK = 8;         // features staged per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 threads, PER x PER outputs each
constexpr int PER = 4;
constexpr int LOAD_ROWS = THREADS / DK;  // rows one load pass covers (32)

// Family ids: the `cuda_id` of each family in repro_torch/families.py.
enum Family : int { GAUSSIAN = 0, LAPLACIAN = 1, LINEAR = 2, MATERN32 = 3, CAUCHY = 4 };

__device__ __forceinline__ float family_epilogue(int fam, float pre, float s) {
  switch (fam) {
    case GAUSSIAN:
      return expf(-pre * s);
    case LAPLACIAN:
      return expf(-sqrtf(pre + 1e-30f) * s);
    case LINEAR:
      return pre;
    case MATERN32: {
      const float r = sqrtf(pre + 1e-30f) * s;
      return (1.0f + r) * expf(-r);
    }
    case CAUCHY:
      return 1.0f / (1.0f + pre * s);
    default:
      return __int_as_float(0x7fc00000);  // NaN: the wrappers never pass another id
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct TileSmem {
  float xs[DK][TILE + 4];  // X chunk, transposed: xs[feature][row]
  float zs[DK][TILE + 4];  // Z chunk, transposed
  float xn[TILE];          // squared row norms of the X tile
  float zn[TILE];          // squared row norms of the Z tile
};

// g[i][j] = k(x[row0 + ty + 16 i], z[col0 + tx + 16 j]); 0 outside [n) x [m).
// Every thread of the block must call it (it synchronises the block).
__device__ __forceinline__ void gram_tile(const float* __restrict__ x, int n, int row0,
                                          const float* __restrict__ z, int m, int col0,
                                          int d, int fam, float s, bool bf16,
                                          TileSmem& sm, float g[PER][PER]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lc = tid % DK;        // the feature this thread loads
  const int lr0 = tid / DK;       // the first row this thread loads
  float acc[PER][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[i][j] = 0.0f;
  float xsq[TILE / LOAD_ROWS], zsq[TILE / LOAD_ROWS];
#pragma unroll
  for (int e = 0; e < TILE / LOAD_ROWS; ++e) xsq[e] = zsq[e] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    const int c = k0 + lc;
#pragma unroll
    for (int e = 0; e < TILE / LOAD_ROWS; ++e) {
      const int lr = lr0 + LOAD_ROWS * e;
      const int gx = row0 + lr, gz = col0 + lr;
      float xv = (gx < n && c < d) ? x[(long long)gx * d + c] : 0.0f;
      float zv = (gz < m && c < d) ? z[(long long)gz * d + c] : 0.0f;
      xsq[e] = fmaf(xv, xv, xsq[e]);
      zsq[e] = fmaf(zv, zv, zsq[e]);
      if (bf16) {
        xv = round_bf16(xv);
        zv = round_bf16(zv);
      }
      sm.xs[lc][lr] = xv;
      sm.zs[lc][lr] = zv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      float a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) a[i] = sm.xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < PER; ++j) b[j] = sm.zs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Row norms: the DK lanes that loaded one row sit next to each other in a
  // warp; a fixed butterfly sums their per-lane partials.
#pragma unroll
  for (int e = 0; e < TILE / LOAD_ROWS; ++e) {
#pragma unroll
    for (int off = DK / 2; off > 0; off /= 2) {
      xsq[e] += __shfl_xor_sync(0xffffffffu, xsq[e], off);
      zsq[e] += __shfl_xor_sync(0xffffffffu, zsq[e], off);
    }
    if (lc == 0) {
      sm.xn[lr0 + LOAD_ROWS * e] = xsq[e];
      sm.zn[lr0 + LOAD_ROWS * e] = zsq[e];
    }
  }
  __syncthreads();

  const bool dot_only = fam == LINEAR;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int cc = tx + 16 * j;
      float pre = acc[i][j];
      if (!dot_only) pre = fmaxf(sm.xn[r] + sm.zn[cc] - 2.0f * pre, 0.0f);
      const float v = family_epilogue(fam, pre, s);
      g[i][j] = (row0 + r < n && col0 + cc < m) ? v : 0.0f;
    }
  }
}

}  // namespace repro
