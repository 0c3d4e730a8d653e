// K9: the Mamba-2 SSD chunk scan on Hopper (sm_90a), hand-written CUDA C++.
// The (Q, Q) decay tensor L is never written to device memory.
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
// 2 P per (q, k <= q) pair for y_diag, grow with the chunk. This design also
// moves the chunk states, (B, S/Q, H, P, N) fp32 (67 MB at Jamba's shape and
// chunk 64), four times (written, read and rewritten, read) and reads x, B
// and dt twice.
//
// Design: the chunked algorithm's own parallel structure (the reference's
// `ssd_chunked`, ported as ref.py), in three launches. The TPU's sequential
// chunk axis becomes one short fixed-order scan over the chunk states; the
// chunk-local work runs in parallel over (batch, chunk, head group).
//  (a) ssd_chunk_state_kernel, grid (head groups, chunks, batch), 256
//      threads: per head the in-chunk cumulative log-decay (a fixed-order
//      warp scan) and the chunk's end state S_c = sum_r exp(total - cum_r)
//      dt_r x_r (x) B_r, (P, N) fp32, and its decay exp(total). The block's
//      B rows are staged once for all its heads, its x rows stream through
//      two 16-row cp.async slabs, and each thread accumulates a 4 (head, p)
//      column x 8 state column register tile.
//  (b) ssd_state_passing_kernel, grid over (batch, H P N elements): each
//      thread walks the chunks in order, state_in[c] = running, then
//      running = exp(total_c) running + S_c (in place of S_c), and writes
//      the final state.
//  (c) ssd_chunk_scan_kernel, grid (head groups, chunks, batch), 256
//      threads: C B^T once per block, shared by its heads (B and C are one
//      group for all heads of a batch row); per head L * C B^T (one expf per
//      pair k <= q), then y = (L * C B^T)(dt x) + exp(cum) C state_in^T in
//      4 x 4 register tiles. A tile's rows are two at the top of the chunk
//      and their mirror images at the bottom, so every tile does the same
//      work over the triangle. The next head's x and state land by cp.async
//      while a head is computed; y is written once, in x's dtype.
// All products are fp32 FMA (expf, no fast math). No float atomics and every
// sum in a fixed order: the result is bit-repeatable. Rows past S act as rows
// padded with dt = 0, x = B = C = 0 (an identity step, as the reference's
// wrapper pads them) and are not stored; a chunk of q rows is held as
// round_up(q, 4) rows, the extra ones identity rows too. x and y are fp32 or
// bf16, dt, a, B, C and the state fp32.
//
// Later work: the chunk scan takes about three quarters of the time. Its
// 128-thread 4 x 8-tile and parity-split 8 x 4-tile variants (fewer
// shared-memory bytes per FMA) ran slower on the card; a warp that only
// loads (the next head's x, state and L * C B^T) beside warps that only
// multiply is untried. Tensor cores stay out while K9 is IEEE fp32.
#include <cuda_bf16.h>

#include "cp_async.cuh"
#include "launchers.h"

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;

namespace {

constexpr int THREADS = 256;       // threads of every K9 block
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_HEADS_MAX = 8;  // most heads per chunk-scan block
constexpr int SCOLS = 512;         // most (head, p) columns per chunk-state block
constexpr int SHG_MAX = 64;        // most heads per chunk-state block
constexpr int STC = 4;             // (head, p) columns of a chunk-state thread's tile
constexpr int STN = 8;             // state columns of a chunk-state thread's tile
constexpr int RS = 16;             // x rows per slab of the chunk-state kernel
constexpr int PASS_GROUP = 8;      // chunks whose states a state-passing thread loads at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& out, float v) { out = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& out, float v) {
  out = __float2bfloat16_rn(v);
}

// Four consecutive values of T at p (16-byte aligned for fp32, 8-byte for bf16).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi), v[3] = __high2float(hi);
}

// The first `cnt` of 4 consecutive values of y's row at element o, in T;
// one vector store when all 4 are wanted and `vec` (the row offset is
// 4-aligned).
__device__ __forceinline__ void store4(float* y, long long o, const float (&v)[4], int cnt,
                                       bool vec) {
  if (vec && cnt == 4) {
    *reinterpret_cast<float4*>(y + o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < cnt; ++i) y[o + i] = v[i];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, long long o, const float (&v)[4],
                                       int cnt, bool vec) {
  if (vec && cnt == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<unsigned*>(&lo);
    w.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(y + o) = w;
  } else {
    for (int i = 0; i < cnt; ++i) from_f(y[o + i], v[i]);
  }
}

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

// The most heads a chunk-state block takes at head dim p: 512 columns'
// worth, at most 64 (ssd/ops.py's ssd_plan gives the count).
__host__ __device__ inline int state_heads_max(int p) {
  return max(1, min(SHG_MAX, SCOLS / p));
}

// The chunk's inclusive cumulative sum of dt a over its q4 rows, by one warp
// in a fixed order: each lane sums a run of consecutive rows in order, then
// a shuffle scan adds the runs. dts holds dt (0 on identity rows).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float ah, float* cum, int q4,
                                             int lane) {
  const int per = (q4 + 31) / 32, r0 = lane * per;
  float run = 0.0f;
  for (int r = r0; r < r0 + per && r < q4; ++r) run += dts[r] * ah;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float acc = __shfl_up_sync(0xffffffffu, incl, 1);  // the runs before this lane's
  if (lane == 0) acc = 0.0f;
  for (int r = r0; r < r0 + per && r < q4; ++r) {
    acc += dts[r] * ah;
    cum[r] = acc;
  }
}

// dt of row r of the chunk starting at c0 for head h; 0 on identity rows.
__device__ __forceinline__ float dt_at(const float* dt, int b, int s, int hn, int h, int c0,
                                       int r, int q) {
  const int t = c0 + r;
  return (r < q && t < s) ? dt[(static_cast<long long>(b) * s + t) * hn + h] : 0.0f;
}

// ---------------------------------------------------------------------------
// (a) the chunk states
// ---------------------------------------------------------------------------

// Rows r0 .. r0 + RS of the chunk-state block's x columns into dst (RS rows
// of `cols` T values), by cp.async where the rows allow it (16-byte pieces
// if p sizeof(T) is a multiple of 16; else 4-byte ones for fp32, plain
// loads for bf16); rows from `rows` on as zeros. One commit group.
template <typename T>
__device__ __forceinline__ void fetch_slab(const T* xb, long long xstride, T* dst, int r0,
                                           int rows, int cols, bool vec16, int tid) {
  if (vec16) {
    const int per = cols * static_cast<int>(sizeof(T)) / 16;
    for (int e = tid; e < RS * per; e += THREADS) {
      const int r = e / per, k = e - r * per;
      const bool ok = r0 + r < rows;
      const char* src = reinterpret_cast<const char*>(xb + (ok ? r0 + r : 0) * xstride) + 16 * k;
      cp_async16(reinterpret_cast<char*>(dst) + 16 * e, reinterpret_cast<const float*>(src),
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < RS * cols; e += THREADS) {
      const int r = e / cols, k = e - r * cols;
      const bool ok = r0 + r < rows;
      const T* src = xb + (ok ? r0 + r : 0) * xstride + k;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + e, reinterpret_cast<const float*>(src), ok ? 4 : 0);
      } else {
        if (ok) dst[e] = *src;
        else from_f(dst[e], 0.0f);
      }
    }
  }
  cp_async_commit();
}

// Offsets (in floats) of the chunk-state block's shared memory for hg heads
// and x of `tsize` bytes an element; every region starts on a 16-byte boundary.
struct StateLayout {
  int bs, u, dts, cum, xsl, total;
};

__host__ __device__ inline StateLayout state_layout(int p, int n, int q, int hg, int tsize) {
  const int q4 = round4(q);
  StateLayout l;
  l.bs = 0;                           // [q4][round8(n)] B rows of the chunk
  l.u = l.bs + q4 * round8(n);        // [q4][hg] exp(total - cum_r) dt_r per head
  l.dts = l.u + round4(q4 * hg);      // [WARPS][q4] dt of a warp's head
  l.cum = l.dts + WARPS * q4;         // [WARPS][q4] its cumulative dt a
  l.xsl = l.cum + WARPS * q4;         // [2][RS][hg p] two slabs of x rows (T)
  l.total = l.xsl + round4((2 * RS * hg * p * tsize + 3) / 4);
  return l;
}

// (a) states[b, chunk, h] (P, N) = sum_r exp(total - cum_r) dt_r x[r, h, :] (x) B[r, :]
// and decay[b, chunk, h] = exp(total), for the block's heads g0 .. g0 + hg.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const float* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ decay, int s, int hn, int p,
                       int n, int q, int hg) {
  extern __shared__ __align__(16) float smem[];
  const StateLayout L = state_layout(p, n, q, hg, sizeof(T));
  const int q4 = round4(q), n8 = round8(n);
  float* bs = smem + L.bs;
  float* u = smem + L.u;
  T* xsl = reinterpret_cast<T*>(smem + L.xsl);
  const int g0 = blockIdx.x * hg, chunk = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int nh = min(hg, hn - g0);
  const int c0 = chunk * q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Column col = hl p + pp of the group is (head g0 + hl, p index pp).
  const int cols = nh * p;
  const int rows = min(q, s - c0);
  const int nslab = (rows + RS - 1) / RS;
  const long long xstride = static_cast<long long>(hn) * p;  // between rows of x
  const T* xb = x + (static_cast<long long>(b) * s + c0) * xstride + static_cast<long long>(g0) * p;
  const bool vec16 = (p * static_cast<int>(sizeof(T))) % 16 == 0;
  // a thread's 4 columns are one head's, and 8- (bf16) or 16-byte (fp32) aligned
  const bool vec = p % STC == 0;
  fetch_slab(xb, xstride, xsl, 0, rows, cols, vec16, tid);  // lands while u is formed

  for (int e = tid; e < q4 * n8; e += THREADS) {
    const int r = e / n8, j = e - r * n8, t = c0 + r;
    bs[e] = (r < q && t < s && j < n) ? bm[(static_cast<long long>(b) * s + t) * n + j] : 0.0f;
  }
  // u[r][hl] = exp(total - cum_r) dt_r, one warp per head
  for (int hl = warp; hl < nh; hl += WARPS) {
    const int h = g0 + hl;
    float* dw = smem + L.dts + warp * q4;
    float* cw = smem + L.cum + warp * q4;
    for (int r = lane; r < q4; r += 32) dw[r] = dt_at(dt, b, s, hn, h, c0, r, q);
    __syncwarp();
    chunk_cumsum(dw, a[h], cw, q4, lane);
    __syncwarp();
    const float total = cw[q4 - 1];
    for (int r = lane; r < q4; r += 32) u[r * hg + hl] = expf(total - cw[r]) * dw[r];
    if (lane == 0) decay[(static_cast<long long>(b) * nc + chunk) * hn + h] = expf(total);
    __syncwarp();  // the warp's next head reuses dw and cw
  }

  // Items (column group of STC, state group of STN), state group fastest: a
  // warp's x loads are 16 groups side by side, its B loads two addresses.
  float* sb = states + ((static_cast<long long>(b) * nc + chunk) * hn + g0) * p * n;
  const int ngroups = n8 / STN;
  const int items = (cols + STC - 1) / STC * ngroups;
  for (int i0 = 0; i0 < items; i0 += THREADS) {
    const int item = i0 + tid;
    const bool active = item < items;
    const int cg = item / ngroups, ng = item - cg * ngroups;
    const int col = STC * cg, j0 = STN * ng;
    int hc[STC];
#pragma unroll
    for (int c = 0; c < STC; ++c) hc[c] = min(col + c, cols - 1) / p;
    if (i0 > 0) fetch_slab(xb, xstride, xsl, 0, rows, cols, vec16, tid);
    float acc[STC][STN];
#pragma unroll
    for (int c = 0; c < STC; ++c)
#pragma unroll
      for (int j = 0; j < STN; ++j) acc[c][j] = 0.0f;
    for (int sl = 0; sl < nslab; ++sl) {
      const T* xc = xsl + (sl & 1) * RS * cols;
      const bool next = sl + 1 < nslab;
      if (next)
        fetch_slab(xb, xstride, xsl + ((sl + 1) & 1) * RS * cols, (sl + 1) * RS, rows, cols,
                   vec16, tid);
      if (next)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // the slab has landed (and, the first time, u and B are in place)
      const int r1 = min(RS, rows - sl * RS);
      if (active) {
#pragma unroll 2
        for (int r = 0; r < r1; ++r) {
          const int rr = sl * RS + r;
          float v[STC];
          if (vec) {
            load4(xc + r * cols + col, v);
            const float ur = u[rr * hg + hc[0]];
#pragma unroll
            for (int c = 0; c < STC; ++c) v[c] *= ur;
          } else {
#pragma unroll
            for (int c = 0; c < STC; ++c)
              v[c] = col + c < cols ? u[rr * hg + hc[c]] * to_f(xc[r * cols + col + c]) : 0.0f;
          }
          float bv[STN];
          const float4 b0 = *reinterpret_cast<const float4*>(bs + rr * n8 + j0);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + rr * n8 + j0 + 4);
          bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
          bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
#pragma unroll
          for (int c = 0; c < STC; ++c)
#pragma unroll
            for (int j = 0; j < STN; ++j) acc[c][j] = fmaf(v[c], bv[j], acc[c][j]);
        }
      }
      __syncthreads();  // the slab's buffer is free for the slab after next
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < STC; ++c) {
        if (col + c >= cols) break;
        float* o = sb + static_cast<long long>(col + c) * n + j0;
        if (n % 4 == 0 && j0 + STN <= n) {  // 32 bytes, 16-byte aligned
          reinterpret_cast<float4*>(o)[0] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
          reinterpret_cast<float4*>(o)[1] = make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
        } else {
#pragma unroll
          for (int j = 0; j < STN; ++j)
            if (j0 + j < n) o[j] = acc[c][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the state passing
// ---------------------------------------------------------------------------

// Over the chunks in order, per element e of (H, P, N): states[b, c] = the
// state entering chunk c (in place of S_c), then running = decay_c running
// + S_c; state[b] = the state after the last chunk. A thread takes VW
// consecutive elements of one head (VW = 4 when P N is a multiple of 4).
template <int VW>
__global__ void __launch_bounds__(THREADS)
ssd_state_passing_kernel(float* __restrict__ states, const float* __restrict__ decay,
                         float* __restrict__ state, int hn, int pn, int nc) {
  const long long per = static_cast<long long>(hn) * pn;
  const long long e = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * VW;
  const int b = blockIdx.y;
  if (e >= per) return;
  const int h = static_cast<int>(e / pn);
  float* sp = states + static_cast<long long>(b) * nc * per + e;
  const float* dp = decay + static_cast<long long>(b) * nc * hn + h;
  float run[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) run[v] = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += PASS_GROUP) {
    float sc[PASS_GROUP][VW], dc[PASS_GROUP];
#pragma unroll
    for (int i = 0; i < PASS_GROUP; ++i) {  // the group's loads in flight together
      const bool ok = c0 + i < nc;
      dc[i] = ok ? dp[static_cast<long long>(c0 + i) * hn] : 0.0f;
      if constexpr (VW == 4) {
        const float4 v4 = ok ? *reinterpret_cast<const float4*>(sp + (c0 + i) * per)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        sc[i][0] = v4.x, sc[i][1] = v4.y, sc[i][2] = v4.z, sc[i][3] = v4.w;
      } else {
        sc[i][0] = ok ? sp[(c0 + i) * per] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < PASS_GROUP; ++i) {
      if (c0 + i < nc) {
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(sp + (c0 + i) * per) =
              make_float4(run[0], run[1], run[2], run[3]);
        else
          sp[(c0 + i) * per] = run[0];
#pragma unroll
        for (int v = 0; v < VW; ++v) run[v] = fmaf(dc[i], run[v], sc[i][v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VW; ++v) state[static_cast<long long>(b) * per + e + v] = run[v];
}

// Offsets (in floats) of the chunk-scan block's shared memory for hg heads
// and x of `tsize` bytes an element; every region starts on a 16-byte
// boundary.
struct ScanLayout {
  int cbt, mt, xs, ct, bt, dts, cum, st, xr, sr, total;
};

// The state's row stride in the chunk scan: p4 + 4 floats, so that its
// transposing writes fall in different banks.
__host__ __device__ inline int state_stride(int p) { return round4(p) + 4; }

__host__ __device__ inline ScanLayout scan_layout(int p, int n, int q, int hg, int tsize) {
  const int q4 = round4(q), p4 = round4(p);
  ScanLayout l;
  l.cbt = 0;                    // [q4][q4] cbt[j][i] = C_i . B_j for j <= i
  l.mt = l.cbt + q4 * q4;       // [q4][q4] mt[j][i] = cbt[j][i] exp(cum_i - cum_j), 0 for j = i + 1
  l.xs = l.mt + q4 * q4;        // [q4][p4] dt x of the current head
  l.ct = l.xs + q4 * p4;        // [n][q4]  C^T
  l.bt = l.ct + n * q4;         // [n][q4]  B^T, until C B^T is formed; then
  l.dts = l.bt;                 // [hg][q4] dt of each head
  l.cum = l.dts + hg * q4;      // [hg][q4] its cumulative dt a
  l.st = l.bt + max(n, 2 * hg) * q4;  // [n][p4 + 4] the current head's state entering the chunk, transposed
  l.xr = l.st + n * state_stride(p);  // [q4][p] x of the next head as stored (T), landing by cp.async
  l.sr = l.xr + round4((q4 * p * tsize + 3) / 4);  // [p][n] its state
  l.total = l.sr + round4(p * n);
  return l;
}

// Head h's x rows and state entering the chunk into xr and sr, by cp.async
// where the rows allow it (16-byte pieces; else 4-byte ones for fp32, plain
// loads for bf16 rows of a byte count that 16 does not divide); rows past
// the chunk or S as zeros. Every thread of the block calls it; one commit
// group.
template <typename T>
__device__ __forceinline__ void fetch_head(const T* x, const float* states, float* xr, float* sr,
                                           int b, int s, int hn, int h, int p, int n, int q,
                                           int c0, int chunk, int nc, int tid) {
  const int q4 = round4(q);
  auto row = [&](int r) {  // x's element offset of row r (a valid row stands in for the rest)
    const int t = (r < q && c0 + r < s) ? c0 + r : c0;
    return ((static_cast<long long>(b) * s + t) * hn + h) * p;
  };
  const int row_bytes = p * static_cast<int>(sizeof(T));
  if (row_bytes % 16 == 0) {
    const int per = row_bytes / 16;
    for (int e = tid; e < q4 * per; e += THREADS) {
      const int r = e / per, k = e - r * per;
      const bool ok = r < q && c0 + r < s;
      cp_async16(reinterpret_cast<char*>(xr) + e * 16,
                 reinterpret_cast<const float*>(reinterpret_cast<const char*>(x + row(r)) + 16 * k),
                 ok ? 16 : 0);
    }
  } else {
    T* xt = reinterpret_cast<T*>(xr);
    for (int e = tid; e < q4 * p; e += THREADS) {
      const int r = e / p, pp = e - r * p;
      const bool ok = r < q && c0 + r < s;
      if constexpr (sizeof(T) == 4) {
        cp_async4(xt + e, reinterpret_cast<const float*>(x + row(r) + pp), ok ? 4 : 0);
      } else {
        if (ok) xt[e] = x[row(r) + pp];
        else from_f(xt[e], 0.0f);
      }
    }
  }
  const float* sh = states + ((static_cast<long long>(b) * nc + chunk) * hn + h) * p * n;
  if ((p * n) % 4 == 0) {
    for (int e = tid; e < p * n / 4; e += THREADS) cp_async16(sr + 4 * e, sh + 4 * e, 16);
  } else {
    for (int e = tid; e < p * n; e += THREADS) cp_async4(sr + e, sh + e, 4);
  }
  cp_async_commit();
}

// (c) y[b, rows of chunk, heads g0 .. g0 + hg] from the states entering the
// chunk (states after (b)). Each head's x and state land by cp.async while
// the previous head is computed; two barriers per head. Registers capped for
// three blocks per SM (the shared memory at chunk 64 and bf16 allows three).
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ states,
                      T* __restrict__ y, int s, int hn, int p, int n, int q, int hg) {
  extern __shared__ __align__(16) float smem[];
  const ScanLayout L = scan_layout(p, n, q, hg, sizeof(T));
  const int q4 = round4(q), p4 = round4(p), sst = state_stride(p);
  float* cbt = smem + L.cbt;
  float* mt = smem + L.mt;
  float* xs = smem + L.xs;
  float* ct = smem + L.ct;
  float* bt = smem + L.bt;
  float* st = smem + L.st;
  float* xr = smem + L.xr;
  float* sr = smem + L.sr;
  const int g0 = blockIdx.x * hg, chunk = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int nh = min(hg, hn - g0);
  const int c0 = chunk * q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  fetch_head(x, states, xr, sr, b, s, hn, g0, p, n, q, c0, chunk, nc, tid);
  for (int e = tid; e < q4 * n; e += THREADS) {  // rows fastest: conflict-free transposed writes
    const int j = e / q4, r = e - j * q4, t = c0 + r;
    const bool ok = r < q && t < s;
    const long long o = (static_cast<long long>(b) * s + t) * n + j;
    ct[e] = ok ? cm[o] : 0.0f;
    bt[e] = ok ? bm[o] : 0.0f;
  }
  __syncthreads();
  // C B^T once for the block's heads, 4 x 4 tiles on and below the diagonal
  const int nt = q4 / 4;
  for (int tile = tid; tile < nt * nt; tile += THREADS) {
    const int it = tile / nt, jt = tile - it * nt;
    if (jt > it) continue;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float4 c4 = *reinterpret_cast<const float4*>(ct + k * q4 + 4 * it);
      const float4 b4 = *reinterpret_cast<const float4*>(bt + k * q4 + 4 * jt);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(cbt + (4 * jt + j) * q4 + 4 * it) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  }

  __syncthreads();  // B^T is read; its space takes each head's dt and cumulative dt a
  // (one warp per head)
  for (int hl = warp; hl < nh; hl += WARPS) {
    float* dw = smem + L.dts + hl * q4;
    float* cw = smem + L.cum + hl * q4;
    for (int r = lane; r < q4; r += 32) dw[r] = dt_at(dt, b, s, hn, g0 + hl, c0, r, q);
    __syncwarp();
    chunk_cumsum(dw, a[g0 + hl], cw, q4, lane);
  }

  const int cgs = p4 / 4;       // column groups of 4
  const bool vec = p % 4 == 0;  // y's rows 16-byte (fp32) or 8-byte (bf16) aligned
  const T* xrt = reinterpret_cast<const T*>(xr);
  for (int hl = 0; hl < nh; ++hl) {
    const int h = g0 + hl;
    const float* dts = smem + L.dts + hl * q4;
    const float* cum = smem + L.cum + hl * q4;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // head h has landed; C B^T is ready; the previous head is done
    for (int r = warp; r < q4; r += WARPS) {
      const float dv = dts[r];
      for (int pp = lane; pp < p4; pp += 32)
        xs[r * p4 + pp] = pp < p ? dv * to_f(xrt[r * p + pp]) : 0.0f;
    }
    for (int e = tid; e < p * n; e += THREADS) {  // sr read in order; st's padded rows spread the banks
      const int pp = e / n, j = e - pp * n;
      st[j * sst + pp] = sr[e];
    }
    for (int e = tid; e < n * (p4 - p); e += THREADS) {
      const int j = e / (p4 - p);
      st[j * sst + p + e - j * (p4 - p)] = 0.0f;
    }
    // mt[j][i] for the pairs the tiles read, j <= i + 1 (j = i + 1 gives 0)
    for (int j = warp; j < q4; j += WARPS) {
      const float cj = cum[j];
      for (int i = (max(j - 1, 0) & ~31) + lane; i < q4; i += 32)
        mt[j * q4 + i] = j <= i ? cbt[j * q4 + i] * expf(cum[i] - cj) : 0.0f;
    }
    __syncthreads();
    if (hl + 1 < nh)  // the next head lands while this one is computed
      fetch_head(x, states, xr, sr, b, s, hn, h + 1, p, n, q, c0, chunk, nc, tid);

    // Tile (rg, cg): rows ia, ia + 1 and ib, ib + 1 (ia = 2 rg, ib = q4 - 2 - ia),
    // columns 4 cg .. 4 cg + 3. Rows ia, ia + 1 need j < ia + 2, rows ib, ib + 1
    // j < ib + 2: 8 q4 + 16 FMAs per tile, whatever rg.
    for (int item = tid; item < nt * cgs; item += THREADS) {
      const int rg = item / cgs, cg = item - rg * cgs;
      const int ia = 2 * rg, ib = q4 - 2 - ia, p0 = 4 * cg;
      float yl[2][4], yh[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) yl[i][c] = yh[i][c] = 0.0f;
      for (int j = 0; j < ia + 2; ++j) {
        const float2 ml = *reinterpret_cast<const float2*>(mt + j * q4 + ia);
        const float2 mh = *reinterpret_cast<const float2*>(mt + j * q4 + ib);
        const float4 x4 = *reinterpret_cast<const float4*>(xs + j * p4 + p0);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yl[0][c] = fmaf(ml.x, xv[c], yl[0][c]);
          yl[1][c] = fmaf(ml.y, xv[c], yl[1][c]);
          yh[0][c] = fmaf(mh.x, xv[c], yh[0][c]);
          yh[1][c] = fmaf(mh.y, xv[c], yh[1][c]);
        }
      }
      for (int j = ia + 2; j < ib + 2; ++j) {
        const float2 mh = *reinterpret_cast<const float2*>(mt + j * q4 + ib);
        const float4 x4 = *reinterpret_cast<const float4*>(xs + j * p4 + p0);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yh[0][c] = fmaf(mh.x, xv[c], yh[0][c]);
          yh[1][c] = fmaf(mh.y, xv[c], yh[1][c]);
        }
      }
      // y_off before its decay: C_i . state_in[p]
      float ol[2][4], oh[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) ol[i][c] = oh[i][c] = 0.0f;
      for (int k = 0; k < n; ++k) {
        const float2 cl = *reinterpret_cast<const float2*>(ct + k * q4 + ia);
        const float2 ch = *reinterpret_cast<const float2*>(ct + k * q4 + ib);
        const float4 s4 = *reinterpret_cast<const float4*>(st + k * sst + p0);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ol[0][c] = fmaf(cl.x, sv[c], ol[0][c]);
          ol[1][c] = fmaf(cl.y, sv[c], ol[1][c]);
          oh[0][c] = fmaf(ch.x, sv[c], oh[0][c]);
          oh[1][c] = fmaf(ch.y, sv[c], oh[1][c]);
        }
      }
      const int cnt = min(4, p - p0);
      const int rows[4] = {ia, ia + 1, ib, ib + 1};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i], t = c0 + r;
        if (r >= q || t >= s) continue;
        const float e = expf(cum[r]);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = i < 2 ? yl[i][c] + e * ol[i][c] : yh[i - 2][c] + e * oh[i - 2][c];
        store4(y, ((static_cast<long long>(b) * s + t) * hn + h) * p + p0, v, cnt, vec);
      }
    }
  }
}

template <typename T>
void launch_state(const T* x, const float* dt, const float* a, const float* b, float* states,
                  float* decay, int bsz, int s, int h, int p, int n, int q, int hg,
                  cudaStream_t st) {
  const int smem = state_layout(p, n, q, hg, sizeof(T)).total * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(ssd_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((h + hg - 1) / hg, (s + q - 1) / q, bsz);
  ssd_chunk_state_kernel<T><<<grid, THREADS, smem, st>>>(x, dt, a, b, states, decay, s, h, p, n,
                                                          q, hg);
}

template <typename T>
void launch_scan(const T* x, const float* dt, const float* a, const float* b, const float* c,
                 const float* states, T* y, int bsz, int s, int h, int p, int n, int q, int hg,
                 cudaStream_t st) {
  const int smem = scan_layout(p, n, q, hg, sizeof(T)).total * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((h + hg - 1) / hg, (s + q - 1) / q, bsz);
  ssd_chunk_scan_kernel<T><<<grid, THREADS, smem, st>>>(x, dt, a, b, c, states, y, s, h, p, n, q,
                                                         hg);
}

}  // namespace

long long repro::ssd_smem_floats(int p, int n, int q) {
  return max(static_cast<long long>(scan_layout(p, n, q, SCAN_HEADS_MAX, sizeof(float)).total),
             static_cast<long long>(
                 state_layout(p, n, q, state_heads_max(p), sizeof(float)).total));
}

// bsz, s, h, p, n, q >= 1 and the shared memory within the card's 227 KB
// (the binding checks).
void repro::launch_ssd_chunk_state(const void* x, const float* dt, const float* a, const float* b,
                                   float* states, float* decay, int bsz, int s, int h, int p,
                                   int n, int q, int hg, bool bf16, cudaStream_t st) {
  if (bf16)
    launch_state(static_cast<const __nv_bfloat16*>(x), dt, a, b, states, decay, bsz, s, h, p, n,
                 q, hg, st);
  else
    launch_state(static_cast<const float*>(x), dt, a, b, states, decay, bsz, s, h, p, n, q, hg,
                 st);
}

void repro::launch_ssd_state_passing(float* states, const float* decay, float* state, int bsz,
                                     int h, int p, int n, int nc, cudaStream_t st) {
  const long long per = static_cast<long long>(h) * p * n;
  if ((p * n) % 4 == 0) {
    const dim3 grid(static_cast<unsigned>((per / 4 + THREADS - 1) / THREADS), bsz);
    ssd_state_passing_kernel<4><<<grid, THREADS, 0, st>>>(states, decay, state, h, p * n, nc);
  } else {
    const dim3 grid(static_cast<unsigned>((per + THREADS - 1) / THREADS), bsz);
    ssd_state_passing_kernel<1><<<grid, THREADS, 0, st>>>(states, decay, state, h, p * n, nc);
  }
}

void repro::launch_ssd_chunk_scan(const void* x, const float* dt, const float* a, const float* b,
                                  const float* c, const float* states, void* y, int bsz, int s,
                                  int h, int p, int n, int q, int hg, bool bf16,
                                  cudaStream_t st) {
  if (bf16)
    launch_scan(static_cast<const __nv_bfloat16*>(x), dt, a, b, c, states,
                static_cast<__nv_bfloat16*>(y), bsz, s, h, p, n, q, hg, st);
  else
    launch_scan(static_cast<const float*>(x), dt, a, b, c, states, static_cast<float*>(y), bsz,
                s, h, p, n, q, hg, st);
}
