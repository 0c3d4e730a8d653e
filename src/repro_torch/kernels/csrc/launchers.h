// Host-side launchers of the hand-written Hopper kernels, one per kernel
// launch. Each enqueues exactly one kernel on `st` and returns without
// checking: the caller (binding.cpp) runs C10_CUDA_KERNEL_LAUNCH_CHECK()
// after every call. The .cu sources define these with qualified names, so a
// definition that drifts from its declaration here does not compile.
//
// All arrays are fp32, C-contiguous, on the current device.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// K1: out (n, m) = k(x (n, d), z (m, d)).
void launch_gram(const float* x, const float* z, float* out, int n, int m, int d, int fam,
                 float s, bool bf16, cudaStream_t st);

// K4, and stage 1 of K2: out (n, k) = k(x, z) a (m, k).
void launch_knm_matvec(const float* x, const float* z, const float* a, float* out, int n,
                       int m, int d, int k, int fam, float s, bool bf16, cudaStream_t st);

// K3, and stage 2 of K2, first half: partial (n_chunks, m, k) holds, per
// chunk of chunk_rows rows, that chunk's k(x, z)^T y summed in row order.
void launch_knm_t_partial(const float* x, const float* z, const float* y, float* partial,
                          int n, int m, int d, int k, int n_chunks, int chunk_rows, int fam,
                          float s, bool bf16, cudaStream_t st);

// Second half: out[i] = sum over chunks, in index order, of partial[chunk, i].
// Also K6's second launch (the chunks are W column tiles there).
void launch_reduce_partials(const float* partial, float* out, long long len, int n_chunks,
                            cudaStream_t st);

// K5: out (n,) = (kdiag - rowsum((G w) * G)) / lamn with G = k(x (n, d), z (m, d))
// * zmask; w (m, m), zmask (m,), kdiag (n,); m <= 1024.
void launch_rls_score(const float* x, const float* z, const float* w, const float* zmask,
                      const float* kdiag, float* out, int n, int m, int d, int fam, float s,
                      float lamn, bool bf16, cudaStream_t st);

// K6, first half: partial (ceil(m / 64), n) holds, per 64-column tile of
// w (m, m), each row's rowsum((g w)[:, tile] * g[:, tile]) for g (n, m).
void launch_quadform_partial(const float* g, const float* w, float* partial, int n, int m,
                             bool bf16, cudaStream_t st);

}  // namespace repro
