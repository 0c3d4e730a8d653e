// PyTorch binding of the hand-written Hopper kernels: the one translation
// unit that includes PyTorch's extension headers. Each entry takes tensors
// the Python wrappers (kernels/*/ops.py) have allocated and checked, runs
// the launchers of launchers.h on PyTorch's current stream, and calls
// C10_CUDA_KERNEL_LAUNCH_CHECK() after every launch, so a failed launch
// raises in the calling Python frame.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "launchers.h"

namespace {

void check(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

int dim(const at::Tensor& t, int i) { return static_cast<int>(t.size(i)); }

// K_nM^T y through its two launches; n may be 0 (the chunks then sum to 0).
void knm_t_launches(const at::Tensor& x, const at::Tensor& z, const at::Tensor& y,
                    at::Tensor& partial, at::Tensor& out, int64_t chunk_rows, int64_t fam,
                    double s, bool bf16, cudaStream_t st) {
  const int m = dim(z, 0), k = dim(y, 1);
  repro::launch_knm_t_partial(x.data_ptr<float>(), z.data_ptr<float>(), y.data_ptr<float>(),
                              partial.data_ptr<float>(), dim(x, 0), m, dim(x, 1), k,
                              dim(partial, 0), static_cast<int>(chunk_rows),
                              static_cast<int>(fam), static_cast<float>(s), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_reduce_partials(partial.data_ptr<float>(), out.data_ptr<float>(),
                                static_cast<long long>(m) * k, dim(partial, 0), st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

// K1: out (n, m) = k(x (n, d), z (m, d)).
void gram(const at::Tensor& x, const at::Tensor& z, at::Tensor& out, int64_t fam, double s,
          bool bf16) {
  check(x, "x");
  check(z, "z");
  check(out, "out");
  if (x.size(0) == 0 || z.size(0) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  repro::launch_gram(x.data_ptr<float>(), z.data_ptr<float>(), out.data_ptr<float>(),
                     dim(x, 0), dim(z, 0), dim(x, 1), static_cast<int>(fam),
                     static_cast<float>(s), bf16, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K4: out (n, k) = k(x, z) a (m, k).
void knm_matvec(const at::Tensor& x, const at::Tensor& z, const at::Tensor& a, at::Tensor& out,
                int64_t fam, double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(a, "a");
  check(out, "out");
  if (x.size(0) == 0 || a.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  repro::launch_knm_matvec(x.data_ptr<float>(), z.data_ptr<float>(), a.data_ptr<float>(),
                           out.data_ptr<float>(), dim(x, 0), dim(z, 0), dim(x, 1), dim(a, 1),
                           static_cast<int>(fam), static_cast<float>(s), bf16,
                           at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K3: out (m, k) = k(x, z)^T y (n, k); partial is (n_chunks, m, k) scratch with
// n_chunks * chunk_rows >= n and chunk_rows a multiple of the 64-row tile.
void knm_t(const at::Tensor& x, const at::Tensor& z, const at::Tensor& y, at::Tensor& partial,
           at::Tensor& out, int64_t chunk_rows, int64_t fam, double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(y, "y");
  check(partial, "partial");
  check(out, "out");
  if (z.size(0) == 0 || y.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  knm_t_launches(x, z, y, partial, out, chunk_rows, fam, s, bf16,
                 at::cuda::getCurrentCUDAStream());
}

// K2: out (m, k) = k(x, z)^T (k(x, z) v (m, k)); t (n, k) holds the first
// stage, partial as in knm_t.
void falkon_matvec(const at::Tensor& x, const at::Tensor& z, const at::Tensor& v, at::Tensor& t,
                   at::Tensor& partial, at::Tensor& out, int64_t chunk_rows, int64_t fam,
                   double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(v, "v");
  check(t, "t");
  check(partial, "partial");
  check(out, "out");
  if (z.size(0) == 0 || v.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  if (x.size(0) > 0) {
    repro::launch_knm_matvec(x.data_ptr<float>(), z.data_ptr<float>(), v.data_ptr<float>(),
                             t.data_ptr<float>(), dim(x, 0), dim(z, 0), dim(x, 1), dim(v, 1),
                             static_cast<int>(fam), static_cast<float>(s), bf16, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  knm_t_launches(x, z, t, partial, out, chunk_rows, fam, s, bf16, st);
}

// K5: out (n,) = (kdiag - g^T w g) / lamn per row, g = k(x, z) * zmask.
void rls_score(const at::Tensor& x, const at::Tensor& z, const at::Tensor& w,
               const at::Tensor& zmask, const at::Tensor& kdiag, at::Tensor& out, int64_t fam,
               double s, double lamn, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(w, "w");
  check(zmask, "zmask");
  check(kdiag, "kdiag");
  check(out, "out");
  TORCH_CHECK(z.size(0) <= 1024, "rls_score takes at most 1024 centers");
  if (x.size(0) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  repro::launch_rls_score(x.data_ptr<float>(), z.data_ptr<float>(), w.data_ptr<float>(),
                          zmask.data_ptr<float>(), kdiag.data_ptr<float>(),
                          out.data_ptr<float>(), dim(x, 0), dim(z, 0), dim(x, 1),
                          static_cast<int>(fam), static_cast<float>(s),
                          static_cast<float>(lamn), bf16, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K6: out (n,) = rowsum((g w) * g) for g (n, m), w (m, m); partial is
// (ceil(m / 64), n) scratch, one row per 64-column tile of w.
void quadform(const at::Tensor& g, const at::Tensor& w, at::Tensor& partial, at::Tensor& out,
              bool bf16) {
  check(g, "g");
  check(w, "w");
  check(partial, "partial");
  check(out, "out");
  if (g.size(0) == 0 || g.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(g.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  repro::launch_quadform_partial(g.data_ptr<float>(), w.data_ptr<float>(),
                                 partial.data_ptr<float>(), dim(g, 0), dim(g, 1), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_reduce_partials(partial.data_ptr<float>(), out.data_ptr<float>(),
                                static_cast<long long>(g.size(0)), dim(partial, 0), st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gram", &gram, "K1: dense Gram matrix");
  m.def("knm_matvec", &knm_matvec, "K4: K_nM A");
  m.def("knm_t", &knm_t, "K3: K_nM^T Y, fixed-order two-stage sum");
  m.def("falkon_matvec", &falkon_matvec, "K2: K_nM^T K_nM V");
  m.def("rls_score", &rls_score, "K5: fused Eq. 3 score");
  m.def("quadform", &quadform, "K6: rowsum((G W) * G), fixed-order two-stage sum");
}
