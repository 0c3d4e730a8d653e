// K2-K4: the FALKON K_nM contractions on Hopper (sm_90a), hand-written CUDA C++.
// K_nM = k(X, Z) is never stored: every Gram tile is built in registers by
// the shared `gram_tile` (../csrc/gram_tile.cuh), contracted in shared
// memory, and dropped.
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
// What bounds them on this card: the Gram tiles. At the main path's shapes
// (n = 10^6 rows, M = 10^4 centers, d = 18, k = 1) the inputs are ~72 MB and
// the outputs at most 0.4 MB, so the bytes bound is ~0.02 ms; each K_nM
// evaluation is ~2 n M d = 3.6e11 fp32 FMA-FLOPs plus n M exps, i.e. ~6 ms
// at the 67 TFLOP/s fp32 peak. They are bound by operations.
//
// What the design does about it, and what it leaves for later:
//  * K4 (knm_matvec): one block per 64-row tile of X loops over M in
//    64-center chunks and accumulates its (64, k) output rows in registers.
//    No reduction across blocks.
//  * K3 (knm_t): the TPU kernel accumulates one resident (M, k) block over a
//    *sequential* grid. Hopper blocks run in parallel and in no order, so the
//    sum is a fixed-order two-stage one: block (center tile, row chunk) sums
//    its chunk's rows in order into partial[chunk], then `reduce_partials`
//    adds the chunks in index order. No float atomics: the result is
//    bit-repeatable for a given (n, M, k).
//  * K2 (falkon_matvec): T = K_nM V must be complete over all M before
//    G^T T. The TPU keeps the (bn, M) Gram tile in VMEM; at M = 10^4 one
//    32-row tile is 1.3 MB and does not fit in a block's 227 KB. This first
//    version therefore builds every Gram tile twice per call: stage 1 is the
//    K4 kernel writing T (n, k) to device memory, stage 2 the K3 kernels on
//    T. Twice the Gram FLOPs and exps of the fused reference.
//  * K7 (falkon_matvec_masked): K2 with the row mask fused into stage 1's
//    epilogue, T[r, c] = (K_nM V)[r, c] * mask[r, c], written once; stage 2
//    is K3's kernels on T. Stage 1 is one kernel templated on MASKED, so K2
//    and K4 compile to the same code as without it, and an all-ones mask
//    gives K2's result bit for bit (acc * 1.0f is exact). The mask adds n k
//    fp32 reads and n k multiplies to K2's work (20 MB and ~6 us at n = 10^6,
//    k = 5): K7 is bound by operations, as K2 is, and inherits K2's double
//    Gram build.
//  * Output columns k are processed KC at a time (grid axis); k <= KC, the
//    main path's case, builds each Gram tile once per stage.
//  * Rows >= n and centers >= M are masked inside the kernels (gram_tile
//    returns 0 there); nothing is padded, d and k are used as given.
#include "gram_tile.cuh"
#include "launchers.h"

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

// partial[chunk, center tile, kc0:kc0+kw] = sum over the chunk's rows of G^T Y,
// rows taken in order. Grid: (center tiles, row chunks, column chunks).
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

void repro::launch_reduce_partials(const float* partial, float* out, long long len,
                                   int n_chunks, cudaStream_t st) {
  const int threads = 256;
  reduce_partials_kernel<<<(unsigned)((len + threads - 1) / threads), threads, 0, st>>>(
      partial, out, len, n_chunks);
}
