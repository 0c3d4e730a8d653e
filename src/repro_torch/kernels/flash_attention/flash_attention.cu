// K8: causal or bidirectional GQA softmax attention, forward, on Hopper
// (sm_90a), hand-written CUDA C++. The (S, S) score matrix is never written
// to device memory.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:67
// `flash_attention_pallas` (grid (b, h, q block, kv block) with the kv axis
// innermost and sequential: the running max m, sum l and accumulator acc
// live in VMEM scratch across the kv sweep; kv head h // group through the
// index map; causal pruning of kv blocks above the diagonal; the wrapper
// pads S to the tile and D to 128 lanes).
//
// What bounds it on this card: operations. At Jamba's attention layer
// (B = 4, Hq = 32, Hkv = 8, S = 2 048, D = 128, causal) it reads q, k, v and
// writes the output once, 168 MB in bf16 (0.050 ms at 3.35 TB/s), but does
// 4 D operations per unmasked (query, key) pair in the two contractions,
// 1.37e11 in all, and 4 in the softmax. With bf16 operands the contractions
// could run on the tensor cores (989 TFLOP/s dense): 0.155 ms in all, the
// bound chip_smoke.py states. This kernel runs them on the fp32 FMA units,
// whose 67 TFLOP/s peak alone gives 2.07 ms.
//
// Design: one block owns (b, h, a tile of 64 query rows); a loop inside the
// block walks the kv tiles in order (the TPU's sequential kv grid axis) and,
// under `causal`, stops at the diagonal tile. The q tile (pre-scaled), the
// kv tile (K transposed) and the tile of probabilities sit in shared
// memory; each of the 256 threads holds a 4 x 4 block of scores and a
// 4 x (D / 16) block of the accumulator in registers, with the running max
// and sum of its 4 rows. A row's 64 scores are held by the 16 lanes of one
// half-warp, so its max and sum are fixed-order shuffle butterflies: no
// float atomics, bit-repeatable. The kv head is h / (Hq / Hkv): no KV
// replication. Ragged S and D are masked in the kernel (scores of keys past
// S and above the diagonal are the reference's -1e30; lanes past D load
// zeros and are not stored). All math is fp32 (expf, IEEE division); q, k,
// v and the output are fp32 or bf16. Later work: tensor cores (wgmma, or
// mma.sync on bf16 QK^T) and TMA.
#include <cuda_bf16.h>

#include "launchers.h"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG = -1e30f; // the reference's mask value

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& out, float v) { out = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& out, float v) {
  out = __float2bfloat16_rn(v);
}

// DC = columns of the head dim per thread: the tile's head dim is DP = 16 DC
// (D rounded up to a multiple of 32), each thread owning columns tx + 16 j.
// Shared memory (floats): qs[BQ][DP + 1], kt[DP][BK + 1], vs[BK][DP], ps[BQ][BK + 1]
// (the + 1 rows put the two half-warps' rows in different banks).
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv, int s,
                       int d, float scale, int causal) {
  constexpr int DP = 16 * DC;
  constexpr int QS = DP + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][QS], q * scale
  float* kt = qs + BQ * QS;            // [DP][BK + 1], K transposed
  float* vs = kt + DP * (BK + 1);      // [BK][DP]
  float* ps = vs + BK * DP;            // [BQ][BK + 1], probabilities

  const int nq = (s + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;  // the longest causal sweeps start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const long long qbase = ((long long)b * hq + h) * s * d;
  const long long kbase = ((long long)b * hkv + kvh) * s * d;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const bool in = q0 + r < s && c < d;
    qs[r * QS + c] = in ? to_f(q[qbase + (long long)(q0 + r) * d + c]) * scale : 0.0f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  const int nk = causal ? qt + 1 : (s + BK - 1) / BK;
  for (int kt_i = 0; kt_i < nk; ++kt_i) {
    const int k0 = kt_i * BK;
    __syncthreads();  // the previous tile's kt / vs / ps are consumed (and qs is written)
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const bool in = k0 + r < s && c < d;
      const long long g = kbase + (long long)(k0 + r) * d + c;
      kt[c * (BK + 1) + r] = in ? to_f(k[g]) : 0.0f;
      vs[e] = in ? to_f(v[g]) : 0.0f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int c = 0; c < DP; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = kt[c * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

    // streaming softmax: each row's max and sum over its 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= s || (causal && kj > qi)) sc[i][j] = NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, head-dim columns tx + 16 j
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) from_f(out[qbase + (long long)r * d + c], acc[i][j] * inv_l);
    }
  }
}

template <typename T, int DC>
void launch(const T* q, const T* k, const T* v, T* out, int b, int hq, int hkv, int s, int d,
            float scale, bool causal, cudaStream_t st) {
  constexpr int DP = 16 * DC;
  const size_t smem = sizeof(float) * (BQ * (DP + 1) + DP * (BK + 1) + BK * DP + BQ * (BK + 1));
  cudaFuncSetAttribute(flash_attention_kernel<T, DC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_attention_kernel<T, DC><<<grid, THREADS, smem, st>>>(q, k, v, out, hq, hkv, s, d, scale,
                                                             causal);
}

template <typename T>
void dispatch(const T* q, const T* k, const T* v, T* out, int b, int hq, int hkv, int s, int d,
              float scale, bool causal, cudaStream_t st) {
  // the head dim rounded up to a multiple of 32 (16 threads x an even DC)
  const int dp = (d + 31) / 32 * 32;
  switch (dp / 16) {
    case 2: launch<T, 2>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 4: launch<T, 4>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 6: launch<T, 6>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    default: launch<T, 8>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
  }
}

}  // namespace

// b, s >= 1, 1 <= d <= 128, hq % hkv == 0 (the binding checks all four).
void repro::launch_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int b, int hq, int hkv, int s, int d, float scale,
                                   bool causal, bool bf16, cudaStream_t st) {
  if (bf16) {
    dispatch(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), b, hq, hkv,
             s, d, scale, causal, st);
  } else {
    dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<float*>(out), b, hq, hkv, s, d, scale,
             causal, st);
  }
}
