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
// 1.37e11 in all, and 4 in the softmax: 0.155 ms with the contractions at
// the dense bf16 tensor-core peak (989 TFLOP/s), the bound chip_smoke.py
// states; 2.07 ms with them at the 67 TFLOP/s fp32 FMA peak.
//
// Head dims 1 to 256, in both dtypes. D is never padded in device memory:
// each kernel zero-pads it to DP in shared memory and masks the ragged
// columns itself. DP is D rounded up to a multiple of 32 up to 128, and to
// 192 or 256 above (two wide instantiations per kernel, not six); a D the
// dispatch has no case for throws std::invalid_argument (pybind11 raises it
// as a ValueError) instead of running a narrower tile.
//
// Two kernels, one per dtype. Both walk the kv tiles of one (b, h, query
// tile) inside one block (the TPU's sequential kv grid axis), longest causal
// sweep first (query tile nq - 1 - blockIdx.x), and under `causal` stop at
// the diagonal tile. The kv head is h / (Hq / Hkv): no KV replication.
// Reductions are fixed-order shuffle butterflies, with no float atomics, so
// the output repeats bit for bit. Masks are the reference's: scores of keys
// past S and above the diagonal are -1e30, and the epilogue divides by
// max(l, 1e-30). expf and IEEE division throughout (no fast math).
//
// bf16 (`flash_attention_mma_kernel`, FlashAttention-2 on mma.sync): one
// block owns 128 query rows, 8 warps of 16 rows (faster than 64 rows in 4
// warps: each K/V tile staged feeds twice the rows; at about 200 registers
// a thread, one block runs per SM). The q tile is staged once and held in
// registers as ldmatrix A fragments for the whole sweep at DP <= 128; at DP
// 192 and 256 the O accumulator alone is 96 and 128 fp32 registers a lane,
// so the q fragments are reloaded from the staged q tile (which stays in
// shared memory until the epilogue) at every k-step instead: 16 more
// ldmatrix.x4 per warp and kv tile against the 64 of K, and 64 registers
// a lane fewer. K and V stream in 64-key tiles through a 2-stage shared-memory ring
// filled by 16-byte cp.async (zero-filled past S), rows padded by 16 bytes
// so that ldmatrix has no bank conflicts. S = Q K^T is
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with K row-major as the
// "col" operand (bf16 products are exact in fp32, the sum is fp32), scaled
// by 1/sqrt(D) in fp32 (the reference scales q first: they differ only by
// rounding). A row's 64 scores lie across the 4 lanes of a quad, so the
// online softmax's max and sum are two xor-shuffles; l sums the unrounded
// fp32 p, and P is rounded to bf16 in registers as the A operand of O += P V
// (V through ldmatrix.trans): the one step that departs from the reference,
// which keeps p in fp32. D is zero-padded to a multiple of 32 in shared
// memory; D not a multiple of 8 (or a misaligned pointer) stages with plain
// loads instead of cp.async. The epilogue multiplies by 1/l in fp32, rounds
// to bf16 into the warp's own rows of the q tile, and stores them 16 bytes
// at a time.
//
// fp32 (`flash_attention_kernel`, IEEE fp32 on the FMA units, no TF32): one
// block owns (b, h, a tile of 64 query rows). The q tile (pre-scaled), the
// kv tile (K transposed) and the tile of probabilities sit in shared
// memory; each of the 256 threads holds a 4 x 4 block of scores and a
// 4 x (D / 16) block of the accumulator in registers, with the running max
// and sum of its 4 rows. A row's 64 scores are held by the 16 lanes of one
// half-warp, so its max and sum are shuffle butterflies over them. Ragged S
// and D are masked in the kernel (lanes past D load zeros and are not
// stored). At DP = 256 the tiles take (64 * 257 + 256 * 65 + 64 * 256 +
// 64 * 65) * 4 = 214 528 bytes of shared memory (one block per SM, under the
// 232 448-byte opt-in limit) and each thread 4 x 16 accumulators; BQ stays
// 64. Later work for bf16: wgmma, TMA and warp specialisation.
#include <cuda_bf16.h>

#include <cstdint>
#include <stdexcept>
#include <string>

#include "launchers.h"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG = -1e30f; // the reference's mask value

// DC = columns of the head dim per thread: the tile's head dim is DP = 16 DC
// (D rounded up to a multiple of 32), each thread owning columns tx + 16 j.
// Shared memory (floats): qs[BQ][DP + 1], kt[DP][BK + 1], vs[BK][DP], ps[BQ][BK + 1]
// (the + 1 rows put the two half-warps' rows in different banks).
template <int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int hq, int hkv,
                       int s, int d, float scale, int causal) {
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
    qs[r * QS + c] = in ? q[qbase + (long long)(q0 + r) * d + c] * scale : 0.0f;
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
      kt[c * (BK + 1) + r] = in ? k[g] : 0.0f;
      vs[e] = in ? v[g] : 0.0f;
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
      if (c < d) out[qbase + (long long)r * d + c] = acc[i][j] * inv_l;
    }
  }
}

template <int DC>
void launch(const float* q, const float* k, const float* v, float* out, int b, int hq, int hkv,
            int s, int d, float scale, bool causal, cudaStream_t st) {
  constexpr int DP = 16 * DC;
  const size_t smem = sizeof(float) * (BQ * (DP + 1) + DP * (BK + 1) + BK * DP + BQ * (BK + 1));
  cudaFuncSetAttribute(flash_attention_kernel<DC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_attention_kernel<DC><<<grid, THREADS, smem, st>>>(q, k, v, out, hq, hkv, s, d, scale,
                                                          causal);
}

void dispatch(const float* q, const float* k, const float* v, float* out, int b, int hq,
              int hkv, int s, int d, float scale, bool causal, cudaStream_t st) {
  // the head dim rounded up to a multiple of 32 (16 threads x an even DC),
  // then to 192 or 256 above 128
  const int dp = (d + 31) / 32 * 32;
  switch (dp / 16) {
    case 2: launch<2>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 4: launch<4>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 6: launch<6>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 8: launch<8>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 10:
    case 12: launch<12>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    case 14:
    case 16: launch<16>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st); break;
    // no tile takes this head dim: refuse it rather than run a narrower one
    default: throw std::invalid_argument("flash_attention takes a head dim of 1 to 256, got " +
                                         std::to_string(d));
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;  // warps per block, 16 query rows each: BQ 128
constexpr int MMA_BK = 64;    // keys per kv tile
constexpr int MMA_PAD = 8;    // bf16 elements of padding per shared-memory row

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Rows [r0, r0 + ROWS) of one head's (s, d) matrix into shared rows of
// DP + MMA_PAD elements, zeros past s and past d: 16-byte cp.async if `vec`
// (d % 8 == 0, 16-byte aligned), else plain loads and stores.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int s, int d, bool vec, int tid) {
  constexpr int LD = DP + MMA_PAD;
  if (vec) {
    constexpr int CH = DP / 8;
#pragma unroll
    for (int e = tid; e < ROWS * CH; e += NT) {
      const int r = e / CH, c = e % CH * 8;
      const bool in = r0 + r < s && c < d;
      cp_async16(smem_u32(dst + r * LD + c), in ? src + (long long)(r0 + r) * d + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      dst[r * LD + c] = r0 + r < s && c < d ? src[(long long)(r0 + r) * d + c]
                                            : __float2bfloat16_rn(0.0f);
    }
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t holds, of a 16 x 8
// fp32 tile, rows g (elements 0, 1) and g + 8 (2, 3) at columns 2 t, 2 t + 1.
template <int DP>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           int hq, int hkv, int s, int d, float scale, int causal, int vec) {
  constexpr int BQ_ = 16 * MMA_WARPS, NT = 32 * MMA_WARPS, LD = DP + MMA_PAD;
  constexpr int KS = DP / 16;      // k-steps of Q K^T; column pairs of P V
  constexpr int NS = MMA_BK / 8;   // 8-key score tiles per kv tile
  constexpr bool Q_IN_REGS = DP <= 128;  // else reloaded from qs at every k-step
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [BQ_][LD]
  __nv_bfloat16* ks = qs + BQ_ * LD;                                 // [2][MMA_BK][LD]
  __nv_bfloat16* vs = ks + 2 * MMA_BK * LD;                          // [2][MMA_BK][LD]

  const int nq = (s + BQ_ - 1) / BQ_;
  const int q0 = (nq - 1 - blockIdx.x) * BQ_;  // the longest causal sweeps start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const __nv_bfloat16* qg = q + ((long long)b * hq + h) * s * d;
  const __nv_bfloat16* kg = k + ((long long)b * hkv + kvh) * s * d;
  const __nv_bfloat16* vg = v + ((long long)b * hkv + kvh) * s * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + 16 * warp;  // the warp's first query row
  const int nk = ((causal ? min(s, q0 + BQ_) : s) + MMA_BK - 1) / MMA_BK;

  stage_rows<BQ_, DP, NT>(qs, qg, q0, s, d, vec, tid);
  stage_rows<MMA_BK, DP, NT>(ks, kg, 0, s, d, vec, tid);
  stage_rows<MMA_BK, DP, NT>(vs, vg, 0, s, d, vec, tid);
  cp_async_commit();

  unsigned qf[Q_IN_REGS ? KS : 1][4];
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.0f, 0.0f};

  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) {  // the next tile into the other stage, freed at the end of it - 1
      stage_rows<MMA_BK, DP, NT>(ks + (st ^ 1) * MMA_BK * LD, kg, (it + 1) * MMA_BK, s, d, vec,
                                 tid);
      stage_rows<MMA_BK, DP, NT>(vs + (st ^ 1) * MMA_BK * LD, vg, (it + 1) * MMA_BK, s, d, vec,
                                 tid);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile it (and, at it = 0, the q tile) has landed
    __syncthreads();
    if (Q_IN_REGS && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (Q_IN_REGS ? KS : 1); ++kk)
        ldsm_x4(qf[kk], smem_u32(qs + (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
    }
    const int k0 = it * MMA_BK;
    if (!causal || k0 <= wq0 + 15) {  // else the tile lies above this warp's diagonal
      const __nv_bfloat16* kt = ks + st * MMA_BK * LD;
      const __nv_bfloat16* vt = vs + st * MMA_BK * LD;
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key tiles
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned qa[4];
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[Q_IN_REGS ? kk : 0][e];
        } else {
          ldsm_x4(qa, smem_u32(qs + (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          unsigned bf[4];
          ldsm_x4(bf, smem_u32(kt + (16 * jp + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8));
          mma_bf16(sc[2 * jp], qa, bf[0], bf[1]);
          mma_bf16(sc[2 * jp + 1], qa, bf[2], bf[3]);
        }
      }
      const bool edge = k0 + MMA_BK > s || (causal && k0 + MMA_BK - 1 > wq0);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale;
          if (edge) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1), qi = wq0 + g + 8 * (e >> 1);
            if (kj >= s || (causal && kj > qi)) sc[j][e] = NEG;
          }
        }
      // online softmax for rows g (rr = 0) and g + 8 (rr = 1), each over its quad
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * rr], sc[j][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[rr], mx);
        const float corr = expf(m_run[rr] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            sc[j][e] = expf(sc[j][e] - m_new);
            sum += sc[j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[rr] = corr * l_run[rr] + sum;
        m_run[rr] = m_new;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[j][2 * rr] *= corr;
          o[j][2 * rr + 1] *= corr;
        }
      }
      // O += P V: the score accumulators of keys 16 kk.. are P's A fragment
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          unsigned bf[4];
          ldsm_x4_trans(bf, smem_u32(vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     dp * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed: tile it + 2 may overwrite it
  }

  // Epilogue: O / l in fp32, rounded to bf16 into this warp's own rows of the
  // q tile (no other warp reads them), then stored row by row.
  __nv_bfloat16* os = qs + 16 * warp * LD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float inv_l = 1.0f / fmaxf(l_run[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * rr) * LD + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * rr] * inv_l, o[j][2 * rr + 1] * inv_l);
  }
  __syncwarp();
  __nv_bfloat16* og = out + ((long long)b * hq + h) * s * d;
  if (vec) {
    constexpr int CH = DP / 8;
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = e % CH * 8;
      if (wq0 + r < s && c < d)
        *reinterpret_cast<int4*>(og + (long long)(wq0 + r) * d + c) =
            *reinterpret_cast<const int4*>(os + r * LD + c);
    }
  } else {
    for (int e = lane; e < 16 * DP; e += 32) {
      const int r = e / DP, c = e % DP;
      if (wq0 + r < s && c < d) og[(long long)(wq0 + r) * d + c] = os[r * LD + c];
    }
  }
}

template <int DP>
void launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                __nv_bfloat16* out, int b, int hq, int hkv, int s, int d, float scale, bool causal,
                bool vec, cudaStream_t st) {
  constexpr int BQ_ = 16 * MMA_WARPS;
  const size_t smem = sizeof(__nv_bfloat16) * (BQ_ + 4 * MMA_BK) * (DP + MMA_PAD);
  cudaFuncSetAttribute(flash_attention_mma_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const dim3 grid((s + BQ_ - 1) / BQ_, hq, b);
  flash_attention_mma_kernel<DP><<<grid, MMA_WARPS * 32, smem, st>>>(q, k, v, out, hq, hkv, s, d,
                                                                     scale, causal, vec);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

void dispatch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  __nv_bfloat16* out, int b, int hq, int hkv, int s, int d, float scale,
                  bool causal, cudaStream_t st) {
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  // the head dim rounded up to a multiple of 32 (zero columns in shared memory)
  // (then to 192 or 256 above 128)
  switch ((d + 31) / 32) {
    case 1: launch_mma<32>(q, k, v, out, b, hq, hkv, s, d, scale, causal, vec, st); break;
    case 2: launch_mma<64>(q, k, v, out, b, hq, hkv, s, d, scale, causal, vec, st); break;
    case 3: launch_mma<96>(q, k, v, out, b, hq, hkv, s, d, scale, causal, vec, st); break;
    case 4: launch_mma<128>(q, k, v, out, b, hq, hkv, s, d, scale, causal, vec, st); break;
    case 5:
    case 6: launch_mma<192>(q, k, v, out, b, hq, hkv, s, d, scale, causal, vec, st); break;
    case 7:
    case 8: launch_mma<256>(q, k, v, out, b, hq, hkv, s, d, scale, causal, vec, st); break;
    // no tile takes this head dim: refuse it rather than run a narrower one
    default: throw std::invalid_argument("flash_attention takes a head dim of 1 to 256, got " +
                                         std::to_string(d));
  }
}

}  // namespace

// b, s >= 1, 1 <= d <= 256, hq % hkv == 0 (the binding checks all four).
void repro::launch_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int b, int hq, int hkv, int s, int d, float scale,
                                   bool causal, bool bf16, cudaStream_t st) {
  if (bf16) {
    dispatch_mma(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), b, hq,
                 hkv, s, d, scale, causal, st);
  } else {
    dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<float*>(out), b, hq, hkv, s, d, scale,
             causal, st);
  }
}
