// Host-side launchers of the hand-written Hopper kernels, one per kernel
// launch. Each enqueues exactly one kernel on `st` and returns without
// checking: the caller (binding.cpp) runs C10_CUDA_KERNEL_LAUNCH_CHECK()
// after every call. The .cu sources define these with qualified names, so a
// definition that drifts from its declaration here does not compile.
//
// All arrays are C-contiguous, on the current device, and fp32 unless a
// declaration says otherwise (K8 and K9 take fp32 or bf16 activations).
#pragma once

#include <cuda_runtime.h>

namespace repro {

// K1 on the tiled route (d above 64): out (n, m) = k(x (n, d), z (m, d)).
void launch_gram(const float* x, const float* z, float* out, int n, int m, int d, int fam,
                 float s, bool bf16, cudaStream_t st);

// K1 on the wide route (d <= 64): the same from the rows' squared norms xnorm
// (n,) and znorm (m,) (launch_row_norms), blocks of 128 rows walking `run`
// 128-column tiles; vec (m % 4 == 0) writes 16-byte stores, else 4-byte.
void launch_gram_wide(const float* x, const float* z, const float* xnorm, const float* znorm,
                      float* out, int n, int m, int d, int run, bool vec, int fam, float s,
                      bool bf16, cudaStream_t st);

// Floats of dynamic shared memory one block of launch_gram_wide takes at d features.
long long gram_wide_smem_floats(int d);

// K2 and K7 on the cluster route, each Gram value built once: partial
// (n_chunks, m, k) holds, per row chunk of chunk_rows rows (a multiple of 16),
// that chunk's k(x, z)^T diag(mask) k(x, z) v (m, k); mask (n, k), or nullptr
// for K2; xnorm (n,) the rows' squared norms (launch_row_norms). Thread-block
// clusters of `cluster` (1, 2, 4 or 8) blocks, block b owning centers
// [b slice, (b + 1) slice), slice a multiple of 256 with (cluster - 1) slice
// < m <= cluster slice; kc (1, 2, 4, 5 or 8) output columns per work item;
// d <= 64. The chunks are added by launch_reduce_partials_blocked.
void launch_falkon_matvec_fused(const float* x, const float* z, const float* v,
                                const float* mask, const float* xnorm, float* partial, int n,
                                int m, int d, int k, int cluster, int slice, int kc,
                                int chunk_rows, int n_chunks, int fam, float s, bool bf16,
                                cudaStream_t st);

// The first launch of the cluster route, of K3's and K4's register routes
// and of K1's wide route: out (n,) = the squared norms of x's rows.
void launch_row_norms(const float* x, float* out, int n, int d, cudaStream_t st);

// The last launch of the cluster route and of K3's and K4's register routes:
// out[i] = sum over chunks of partial[chunk, i], i < len, in groups of 32
// chunks (each group in index order, then the groups), times mask[i] unless
// mask is nullptr (K7's stage 1 over several center chunks).
void launch_reduce_partials_blocked(const float* partial, const float* mask, float* out,
                                    long long len, int n_chunks, cudaStream_t st);

// Floats of dynamic shared memory one block of launch_falkon_matvec_fused
// takes for a slice of `slice` centers, d features and kc columns.
long long falkon_fused_smem_floats(int slice, int d, int kc);

// K4 on the tiled route (d above 32), and stage 1 of K2 on the two-stage
// route there: out (n, k) = k(x, z) a (m, k).
void launch_knm_matvec(const float* x, const float* z, const float* a, float* out, int n,
                       int m, int d, int k, int fam, float s, bool bf16, cudaStream_t st);

// K7, stage 1 on the two-stage route at d above 32: out (n, k) = (k(x, z) a (m, k)) * mask (n, k),
// elementwise.
void launch_knm_matvec_masked(const float* x, const float* z, const float* a, const float* mask,
                              float* out, int n, int m, int d, int k, int fam, float s,
                              bool bf16, cudaStream_t st);

// K3, and stage 2 of K2 and K7 on the two-stage route, on the register route
// (d <= 32): partial (n_chunks, m, k) holds, per chunk of chunk_rows rows (a
// multiple of 64), that chunk's k(x, z)^T y, from x's row norms xnorm (n,)
// (launch_row_norms); kc (1, 2, 4, 5 or 8) output columns per block. The
// chunks are added by launch_reduce_partials_blocked. mask (m, k), or
// nullptr, multiplies each sum as it is written (n_chunks 1 only). K4's
// register route, and stage 1 of the two-stage route at d <= 32, call it with
// x and z swapped: k(X, Z) A = k(Z, X)^T A.
void launch_knm_t_reg(const float* x, const float* z, const float* y, const float* xnorm,
                      const float* mask, float* partial, int n, int m, int d, int k, int kc,
                      int chunk_rows, int n_chunks, int fam, float s, bool bf16,
                      cudaStream_t st);

// The same on the tiled route (d above 32), first half: partial
// (n_chunks, m, k) holds, per chunk of chunk_rows rows, that chunk's
// k(x, z)^T y summed in row order.
void launch_knm_t_partial(const float* x, const float* z, const float* y, float* partial,
                          int n, int m, int d, int k, int n_chunks, int chunk_rows, int fam,
                          float s, bool bf16, cudaStream_t st);

// Second half: out[i] = sum over chunks, in index order, of partial[chunk, i].
// Also K6's second launch (the chunks are W column tiles there).
void launch_reduce_partials(const float* partial, float* out, long long len, int n_chunks,
                            cudaStream_t st);

// K5, first half: partial (ceil(m / 128), n) holds, per 128-column tile of
// w (m, m), each row's rowsum((g w)[:, tile] * g[:, tile]) with g = k(x (n, d),
// z (m, d)) * zmask (m,) built on chip; m <= 1024.
void launch_rls_score_partial(const float* x, const float* z, const float* w,
                              const float* zmask, float* partial, int n, int m, int d, int fam,
                              float s, bool bf16, cudaStream_t st);

// K5, second half: out[i] = (K_ii - sum over tiles, in index order, of
// partial[tile, i]) / lamn for i < n, K_ii = k(x_i, x_i) of family fam.
void launch_rls_score_finish(const float* partial, const float* x, float* out, int n, int d,
                             int n_tiles, int fam, float s, float lamn, cudaStream_t st);

// K6, first half: partial (ceil(m / 128), n) holds, per 128-column tile of
// w (m, m), each row's rowsum((g w)[:, tile] * g[:, tile]) for g (n, m).
void launch_quadform_partial(const float* g, const float* w, float* partial, int n, int m,
                             bool bf16, cudaStream_t st);

// K8: out (b, hq, s, d) = softmax(q k^T * scale, masked causally if `causal`) v
// for q (b, hq, s, d) and k, v (b, hkv, s, d), kv head h / (hq / hkv); q, k, v
// and out all fp32 (FMA units), or all bf16 if `bf16` (tensor cores); d <= 128.
void launch_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                            int hq, int hkv, int s, int d, float scale, bool causal, bool bf16,
                            cudaStream_t st);

// K9, the SSD chunk scan, in three launches over x (bsz, s, h, p), dt
// (bsz, s, h), a (h,), b and c (bsz, s, n) in chunks of q rows; x and y fp32,
// or both bf16 if `bf16`; states (bsz, ceil(s / q), h, p, n) and decay
// (bsz, ceil(s / q), h) fp32 scratch. First: each chunk's end state from a
// zero start into states, and exp(sum of dt a over the chunk) into decay,
// blocks of hg heads (hg p <= 512 or hg 1, hg <= 64).
void launch_ssd_chunk_state(const void* x, const float* dt, const float* a, const float* b,
                            float* states, float* decay, int bsz, int s, int h, int p, int n,
                            int q, int hg, bool bf16, cudaStream_t st);

// Second: over the nc chunks in order, states[:, c] becomes the state entering
// chunk c; the final state (bsz, h, p, n) goes to `state`.
void launch_ssd_state_passing(float* states, const float* decay, float* state, int bsz, int h,
                              int p, int n, int nc, cudaStream_t st);

// Third: y (bsz, s, h, p) in x's dtype from the states entering each chunk,
// blocks of hg heads sharing one C B^T.
void launch_ssd_chunk_scan(const void* x, const float* dt, const float* a, const float* b,
                           const float* c, const float* states, void* y, int bsz, int s, int h,
                           int p, int n, int q, int hg, bool bf16, cudaStream_t st);

// Floats of dynamic shared memory the larger of K9's two chunk kernels takes
// per block for head dim p, state dim n and chunk q (the chunk-state kernel
// at its most heads per block).
long long ssd_smem_floats(int p, int n, int q);

}  // namespace repro
