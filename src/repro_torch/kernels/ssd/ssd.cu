// K9: the Mamba-2 SSD chunk scan on Hopper (sm_90a), hand-written CUDA C++.
// Neither the (Q, Q) decay tensor L nor the per-chunk states are written to
// device memory.
//
// Replaces: src/repro/kernels/ssd/ssd.py:81 `ssd_pallas` (grid (batch,
// chunk) with the chunk axis sequential: per chunk the in-chunk cumulative
// log-decay, L = exp(segsum(dt a)) masked to k <= q, y_diag = (C B^T * L)
// (dt x), y_off = exp(cum) (C state^T), and the (H, P, N) state carried in
// VMEM scratch to the next grid step; all heads of a chunk in one step).
//
// What bounds it on this card: bytes in bf16. At Jamba's Mamba layer
// (B = 4, S = 2 048, H = 128, P = 64, N = 16, chunk 64) it reads x, B, C and
// dt and writes y and the state once (275 MB with bf16 x, y, B and C:
// 0.082 ms at 3.35 TB/s). It does about 9e9 operations, 8.7e9 of them in
// contractions: 0.013 ms with those on the bf16 tensor cores, 0.13 ms all at
// the 67 TFLOP/s fp32 peak that this kernel runs on. The chunk's products,
// 2 P per (q, k <= q) pair for y_diag, grow with the chunk.
//
// Design: one block owns (b, h) and walks the chunks in order, carrying the
// (P, N) state in shared memory: this loop replaces the TPU's sequential
// chunk grid axis, since blocks on Hopper run in no order. Per chunk the
// block stages dt x (Q, P), B and C (Q, N) and the (Q, Q) matrix
// G = (C B^T) * L in shared memory; the in-chunk cumulative log-decay is a
// fixed-order warp scan; y_diag (a fixed-order sum over k <= q) and y_off
// are one thread per output; the state update is one thread per (p, n). No
// float atomics: the result is bit-repeatable. Rows past S act as rows
// padded with dt = 0, x = B = C = 0 (an identity step, as the reference's
// wrapper pads them) and are not stored. All math is fp32 (expf); x and y
// are fp32 or bf16, dt, a, B, C and the state fp32. B * H = 512 blocks at
// Jamba's shape fill the 132 SMs about four deep. Later work: the chunk's
// three products on tensor cores, and C B^T shared by the heads of a batch
// row (it is recomputed per head here).
#include <cuda_bf16.h>

#include "launchers.h"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& out, float v) { out = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& out, float v) {
  out = __float2bfloat16_rn(v);
}

// x, y (B, S, H, P); dt (B, S, H); a (H,); b, c (B, S, N); state (B, H, P, N).
// Shared memory (floats): xs[Q][P] (dt x), bs[Q][N + 1], cs[Q][N + 1],
// g[Q][Q + 1], st[P][N + 1], dts[Q], cum[Q], w[Q] (see ssd_smem_floats).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ bm, const float* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ state, int s, int hn, int p, int n, int q) {
  extern __shared__ float smem[];
  const int ns = n + 1, gs = q + 1;
  float* xs = smem;
  float* bs = xs + q * p;
  float* cs = bs + q * ns;
  float* g = cs + q * ns;
  float* st = g + q * gs;
  float* dts = st + p * ns;
  float* cum = dts + q;
  float* w = cum + q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float ah = a[h];
  for (int e = tid; e < p * n; e += THREADS) st[(e / n) * ns + e % n] = 0.0f;

  for (int c0 = 0; c0 < s; c0 += q) {
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int r = tid; r < q; r += THREADS) {
      const int t = c0 + r;
      dts[r] = t < s ? dt[((long long)b * s + t) * hn + h] : 0.0f;
    }
    for (int e = tid; e < q * n; e += THREADS) {
      const int r = e / n, k = e % n, t = c0 + r;
      const long long o = ((long long)b * s + t) * n + k;
      bs[r * ns + k] = t < s ? bm[o] : 0.0f;
      cs[r * ns + k] = t < s ? cm[o] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < q * p; e += THREADS) {
      const int r = e / p, k = e % p, t = c0 + r;
      xs[e] = t < s ? dts[r] * to_f(x[(((long long)b * s + t) * hn + h) * p + k]) : 0.0f;
    }
    if (tid < 32) {
      // inclusive scan of dt a over the chunk: each lane sums a run of
      // consecutive rows in order, then a shuffle scan adds the runs
      const int per = (q + 31) / 32, r0 = tid * per;
      float run = 0.0f;
      for (int r = r0; r < r0 + per && r < q; ++r) run += dts[r] * ah;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);  // the runs before this lane's
      if (tid == 0) acc = 0.0f;
      for (int r = r0; r < r0 + per && r < q; ++r) {
        acc += dts[r] * ah;
        cum[r] = acc;
      }
    }
    __syncthreads();
    const float total = cum[q - 1];
    for (int r = tid; r < q; r += THREADS) w[r] = expf(total - cum[r]);
    // G[i][k] = (C_i . B_k) exp(cum_i - cum_k) for k <= i, else 0
    for (int e = tid; e < q * q; e += THREADS) {
      const int i = e / q, k = e % q;
      float v = 0.0f;
      if (k <= i) {
        for (int j = 0; j < n; ++j) v = fmaf(cs[i * ns + j], bs[k * ns + j], v);
        v *= expf(cum[i] - cum[k]);
      }
      g[i * gs + k] = v;
    }
    __syncthreads();
    // y[i][k] = sum_{j <= i} G[i][j] (dt x)[j][k] + exp(cum_i) C_i . state[k]
    for (int e = tid; e < q * p; e += THREADS) {
      const int i = e / p, k = e % p, t = c0 + i;
      float yd = 0.0f;
      for (int j = 0; j <= i; ++j) yd = fmaf(g[i * gs + j], xs[j * p + k], yd);
      float yo = 0.0f;
      for (int j = 0; j < n; ++j) yo = fmaf(cs[i * ns + j], st[k * ns + j], yo);
      if (t < s) from_f(y[(((long long)b * s + t) * hn + h) * p + k], yd + expf(cum[i]) * yo);
    }
    __syncthreads();
    // state[k][j] = exp(total) state[k][j] + sum_r (dt x)[r][k] exp(total - cum_r) B[r][j]
    const float decay = expf(total);
    for (int e = tid; e < p * n; e += THREADS) {
      const int k = e / n, j = e % n;
      float v = 0.0f;
      for (int r = 0; r < q; ++r) v = fmaf(xs[r * p + k] * w[r], bs[r * ns + j], v);
      st[k * ns + j] = decay * st[k * ns + j] + v;
    }
  }
  __syncthreads();
  for (int e = tid; e < p * n; e += THREADS)
    state[((long long)b * hn + h) * p * n + e] = st[(e / n) * ns + e % n];
}

template <typename T>
void launch(const T* x, const float* dt, const float* a, const float* b, const float* c, T* y,
            float* state, int bsz, int s, int h, int p, int n, int q, cudaStream_t st) {
  const size_t smem = sizeof(float) * repro::ssd_smem_floats(p, n, q);
  cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  ssd_kernel<T><<<dim3(h, bsz), THREADS, smem, st>>>(x, dt, a, b, c, y, state, s, h, p, n, q);
}

}  // namespace

long long repro::ssd_smem_floats(int p, int n, int q) {
  return (long long)q * p + 2LL * q * (n + 1) + (long long)q * (q + 1) + (long long)p * (n + 1) +
         3LL * q;
}

// bsz, s, h, p, n, q >= 1 and the shared memory within the card's 227 KB
// (the binding checks).
void repro::launch_ssd(const void* x, const float* dt, const float* a, const float* b,
                       const float* c, void* y, float* state, int bsz, int s, int h, int p,
                       int n, int q, bool bf16, cudaStream_t st) {
  if (bf16) {
    launch(static_cast<const __nv_bfloat16*>(x), dt, a, b, c, static_cast<__nv_bfloat16*>(y),
           state, bsz, s, h, p, n, q, st);
  } else {
    launch(static_cast<const float*>(x), dt, a, b, c, static_cast<float*>(y), state, bsz, s, h,
           p, n, q, st);
  }
}
