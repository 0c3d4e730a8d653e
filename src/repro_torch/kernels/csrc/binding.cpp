// PyTorch binding of the hand-written Hopper kernels: the one translation
// unit that includes PyTorch's extension headers. Each entry takes tensors
// the Python wrappers (kernels/*/ops.py) have allocated and checked, runs
// the launchers of launchers.h on PyTorch's current stream, and calls
// C10_CUDA_KERNEL_LAUNCH_CHECK() after every launch, so a failed launch
// raises in the calling Python frame.
#include <torch/extension.h>

#include <algorithm>

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

// A CUDA, contiguous tensor of fp32 or bf16 (K8's and K9's activations).
void check_act(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16, name,
              " must be float32 or bfloat16");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// K_nM^T y through its launches, by the route of falkon_matvec/ops.py's
// knm_t_plan: kc > 0 the register route (x's row norms into xnorm (n,),
// knm_t_reg in column chunks of kc, the chunks added in groups of 32); kc 0
// the tiled route (d above 32). partial is (n_chunks, m, k) scratch with
// n_chunks * chunk_rows >= n. n may be 0 (the chunks then sum to 0).
void knm_t_launches(const at::Tensor& x, const at::Tensor& z, const at::Tensor& y,
                    at::Tensor& xnorm, at::Tensor& partial, at::Tensor& out, int64_t kc,
                    int64_t chunk_rows, int64_t fam, double s, bool bf16, cudaStream_t st) {
  const int n = dim(x, 0), m = dim(z, 0), d = dim(x, 1), k = dim(y, 1);
  TORCH_CHECK(partial.dim() == 3 && partial.size(0) * chunk_rows >= n && partial.size(1) == m &&
                  partial.size(2) == k && out.size(0) == m && out.size(1) == k,
              "partial must be (n_chunks, m, k) with n_chunks * chunk_rows >= n");
  if (kc == 0) {
    repro::launch_knm_t_partial(x.data_ptr<float>(), z.data_ptr<float>(), y.data_ptr<float>(),
                                partial.data_ptr<float>(), n, m, d, k, dim(partial, 0),
                                static_cast<int>(chunk_rows), static_cast<int>(fam),
                                static_cast<float>(s), bf16, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    repro::launch_reduce_partials(partial.data_ptr<float>(), out.data_ptr<float>(),
                                  static_cast<long long>(m) * k, dim(partial, 0), st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return;
  }
  check(xnorm, "xnorm");
  TORCH_CHECK(xnorm.numel() == n, "xnorm must hold n = ", n, " values");
  TORCH_CHECK(d >= 1 && d <= 32, "the register route takes 1 to 32 features, got ", d);
  TORCH_CHECK(kc == 1 || kc == 2 || kc == 4 || kc == 5 || kc == 8,
              "kc must be 0 (the tiled route), 1, 2, 4, 5 or 8, got ", kc);
  TORCH_CHECK(chunk_rows > 0 && chunk_rows % 64 == 0, "chunk_rows must be a multiple of 64");
  if (n > 0) {
    repro::launch_row_norms(x.data_ptr<float>(), xnorm.data_ptr<float>(), n, d, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  repro::launch_knm_t_reg(x.data_ptr<float>(), z.data_ptr<float>(), y.data_ptr<float>(),
                          xnorm.data_ptr<float>(), nullptr, partial.data_ptr<float>(), n, m, d,
                          k, static_cast<int>(kc), static_cast<int>(chunk_rows), dim(partial, 0),
                          static_cast<int>(fam), static_cast<float>(s), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_reduce_partials_blocked(partial.data_ptr<float>(), nullptr, out.data_ptr<float>(),
                                        static_cast<long long>(m) * k, dim(partial, 0), st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// k(x, z) a (n, k), times mask (n, k) elementwise unless mask is nullptr,
// into out (n, k), by the route of falkon_matvec/ops.py's knm_matvec_plan: kc
// > 0 the register route, K3's register kernel on the transposed problem
// (k(X, Z) A = k(Z, X)^T A: x's rows are its thread-owned side, the centers
// its streamed side): z's row norms into znorm (m,), then with n_chunks 1 the
// kernel writes out itself (the mask applied as it writes), else it writes
// partial (n_chunks, n, k) and the chunks are added in groups of 32 (the mask
// applied to the sum); kc 0 the tiled route (d above 32). n >= 1; m may be 0
// (the output is then 0).
void knm_matvec_launches(const at::Tensor& x, const at::Tensor& z, const at::Tensor& a,
                         const float* mask, at::Tensor& znorm, at::Tensor& partial,
                         at::Tensor& out, int64_t kc, int64_t n_chunks, int64_t chunk_cols,
                         int64_t fam, double s, bool bf16, cudaStream_t st) {
  const int n = dim(x, 0), m = dim(z, 0), d = dim(x, 1), k = dim(a, 1);
  TORCH_CHECK(out.size(0) == n && out.size(1) == k, "out must be (n, k)");
  if (kc == 0 && mask != nullptr) {
    repro::launch_knm_matvec_masked(x.data_ptr<float>(), z.data_ptr<float>(),
                                    a.data_ptr<float>(), mask, out.data_ptr<float>(), n, m, d, k,
                                    static_cast<int>(fam), static_cast<float>(s), bf16, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return;
  }
  if (kc == 0) {
    repro::launch_knm_matvec(x.data_ptr<float>(), z.data_ptr<float>(), a.data_ptr<float>(),
                             out.data_ptr<float>(), n, m, d, k, static_cast<int>(fam),
                             static_cast<float>(s), bf16, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return;
  }
  check(znorm, "znorm");
  TORCH_CHECK(znorm.numel() == m, "znorm must hold m = ", m, " values");
  TORCH_CHECK(d >= 1 && d <= 32, "the register route takes 1 to 32 features, got ", d);
  TORCH_CHECK(kc == 1 || kc == 2 || kc == 4 || kc == 5 || kc == 8,
              "kc must be 0 (the tiled route), 1, 2, 4, 5 or 8, got ", kc);
  TORCH_CHECK(chunk_cols > 0 && chunk_cols % 64 == 0 && n_chunks >= 1 &&
                  n_chunks * chunk_cols >= m,
              "n_chunks chunks of chunk_cols (a multiple of 64) centers must cover m");
  const bool split = n_chunks > 1;
  if (split) {
    check(partial, "partial");
    TORCH_CHECK(partial.dim() == 3 && partial.size(0) == n_chunks && partial.size(1) == n &&
                    partial.size(2) == k,
                "partial must be (n_chunks, n, k)");
  }
  if (m > 0) {
    repro::launch_row_norms(z.data_ptr<float>(), znorm.data_ptr<float>(), m, d, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  float* target = split ? partial.data_ptr<float>() : out.data_ptr<float>();
  repro::launch_knm_t_reg(z.data_ptr<float>(), x.data_ptr<float>(), a.data_ptr<float>(),
                          znorm.data_ptr<float>(), split ? nullptr : mask, target, m, n, d, k,
                          static_cast<int>(kc), static_cast<int>(chunk_cols),
                          static_cast<int>(n_chunks), static_cast<int>(fam),
                          static_cast<float>(s), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  if (split) {
    repro::launch_reduce_partials_blocked(partial.data_ptr<float>(), mask, out.data_ptr<float>(),
                                          static_cast<long long>(n) * k,
                                          static_cast<int>(n_chunks), st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
}

}  // namespace

// K1: out (n, m) = k(x (n, d), z (m, d)), by the route of gram/ops.py's
// gram_plan: run > 0 the wide route (the rows' squared norms into xnorm (n,)
// and znorm (m,), then blocks of 128 rows walking `run` 128-column tiles; vec
// for 16-byte stores, which needs m % 4 == 0); run 0 the tiled route.
void gram(const at::Tensor& x, const at::Tensor& z, at::Tensor& xnorm, at::Tensor& znorm,
          at::Tensor& out, int64_t run, bool vec, int64_t fam, double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(out, "out");
  const int n = dim(x, 0), m = dim(z, 0), d = dim(x, 1);
  TORCH_CHECK(out.dim() == 2 && out.size(0) == n && out.size(1) == m, "out must be (n, m)");
  if (n == 0 || m == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  if (run == 0) {
    repro::launch_gram(x.data_ptr<float>(), z.data_ptr<float>(), out.data_ptr<float>(), n, m, d,
                       static_cast<int>(fam), static_cast<float>(s), bf16, st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return;
  }
  check(xnorm, "xnorm");
  check(znorm, "znorm");
  TORCH_CHECK(xnorm.numel() == n && znorm.numel() == m, "xnorm, znorm must hold n, m values");
  TORCH_CHECK(d >= 1 && d <= 64, "the wide route takes 1 to 64 features, got ", d);
  TORCH_CHECK(!vec || m % 4 == 0, "16-byte stores need m % 4 == 0, got m = ", m);
  TORCH_CHECK(run >= 1 && ((m + 127) / 128 + run - 1) / run <= 65535,
              "run ", run, " leaves more than 65535 column runs");
  TORCH_CHECK(repro::gram_wide_smem_floats(d) * 4 <= 232448, "d = ", d, " needs more than 227 KB");
  repro::launch_row_norms(x.data_ptr<float>(), xnorm.data_ptr<float>(), n, d, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_row_norms(z.data_ptr<float>(), znorm.data_ptr<float>(), m, d, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_gram_wide(x.data_ptr<float>(), z.data_ptr<float>(), xnorm.data_ptr<float>(),
                          znorm.data_ptr<float>(), out.data_ptr<float>(), n, m, d,
                          static_cast<int>(run), vec, static_cast<int>(fam),
                          static_cast<float>(s), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K4: out (n, k) = k(x, z) a (m, k); znorm (m,) and partial scratch, kc,
// n_chunks and chunk_cols the plan of falkon_matvec/ops.py:knm_matvec_plan
// (see knm_matvec_launches; partial is read only when n_chunks > 1).
void knm_matvec(const at::Tensor& x, const at::Tensor& z, const at::Tensor& a, at::Tensor& znorm,
                at::Tensor& partial, at::Tensor& out, int64_t kc, int64_t n_chunks,
                int64_t chunk_cols, int64_t fam, double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(a, "a");
  check(out, "out");
  if (x.size(0) == 0 || a.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  knm_matvec_launches(x, z, a, nullptr, znorm, partial, out, kc, n_chunks, chunk_cols, fam, s,
                      bf16, at::cuda::getCurrentCUDAStream());
}

// K3: out (m, k) = k(x, z)^T y (n, k); xnorm (n,) and partial scratch, kc
// and chunk_rows the plan of falkon_matvec/ops.py:knm_t_plan (see
// knm_t_launches).
void knm_t(const at::Tensor& x, const at::Tensor& z, const at::Tensor& y, at::Tensor& xnorm,
           at::Tensor& partial, at::Tensor& out, int64_t kc, int64_t chunk_rows, int64_t fam,
           double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(y, "y");
  check(partial, "partial");
  check(out, "out");
  if (z.size(0) == 0 || y.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  knm_t_launches(x, z, y, xnorm, partial, out, kc, chunk_rows, fam, s, bf16,
                 at::cuda::getCurrentCUDAStream());
}

// K2 (mask None) or K7 on the cluster route: out (m, k) = k(x, z)^T diag(mask)
// k(x, z) v (m, k), each Gram value built once; xnorm (n,) scratch for the
// rows' squared norms, partial (n_chunks, m, k) scratch with n_chunks *
// chunk_rows >= n, and (cluster, slice, kc) the plan of
// falkon_matvec/ops.py:matvec_plan. n may be 0 (the chunks then sum to 0).
void falkon_matvec_fused(const at::Tensor& x, const at::Tensor& z, const at::Tensor& v,
                         const c10::optional<at::Tensor>& mask, at::Tensor& xnorm,
                         at::Tensor& partial, at::Tensor& out, int64_t cluster, int64_t slice,
                         int64_t kc, int64_t chunk_rows, int64_t fam, double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(v, "v");
  check(xnorm, "xnorm");
  check(partial, "partial");
  check(out, "out");
  const int64_t n = x.size(0), m = z.size(0), d = x.size(1), k = v.size(1);
  if (mask.has_value()) {
    check(*mask, "mask");
    TORCH_CHECK(mask->dim() == 2 && mask->size(0) == n && mask->size(1) == k,
                "mask must be (n, k) = (", n, ", ", k, "), got ", mask->sizes());
  }
  TORCH_CHECK(xnorm.numel() == n, "xnorm must hold n = ", n, " values");
  TORCH_CHECK(d >= 1 && d <= 64, "the cluster route takes 1 to 64 features, got ", d);
  TORCH_CHECK(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8,
              "cluster must be 1, 2, 4 or 8, got ", cluster);
  TORCH_CHECK(kc == 1 || kc == 2 || kc == 4 || kc == 5 || kc == 8,
              "kc must be 1, 2, 4, 5 or 8, got ", kc);
  TORCH_CHECK(slice > 0 && slice % 256 == 0 && (cluster - 1) * slice < m && m <= cluster * slice,
              "slice ", slice, " does not split ", m, " centers over ", cluster, " blocks");
  TORCH_CHECK(chunk_rows > 0 && chunk_rows % 16 == 0 && partial.dim() == 3 &&
                  partial.size(0) * chunk_rows >= n && partial.size(1) == m &&
                  partial.size(2) == k && out.size(0) == m && out.size(1) == k,
              "partial must be (n_chunks, m, k) with n_chunks * chunk_rows >= n");
  TORCH_CHECK(repro::falkon_fused_smem_floats(static_cast<int>(slice), static_cast<int>(d),
                                              static_cast<int>(kc)) * 4 <= 232448,
              "a slice of ", slice, " centers at d = ", d, " needs more than 227 KB of "
              "shared memory");
  if (m == 0 || k == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  if (n > 0) {
    repro::launch_row_norms(x.data_ptr<float>(), xnorm.data_ptr<float>(), static_cast<int>(n),
                            static_cast<int>(d), st);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  repro::launch_falkon_matvec_fused(
      x.data_ptr<float>(), z.data_ptr<float>(), v.data_ptr<float>(),
      mask.has_value() ? mask->data_ptr<float>() : nullptr, xnorm.data_ptr<float>(),
      partial.data_ptr<float>(), static_cast<int>(n), static_cast<int>(m), static_cast<int>(d),
      static_cast<int>(k), static_cast<int>(cluster), static_cast<int>(slice),
      static_cast<int>(kc), static_cast<int>(chunk_rows), dim(partial, 0), static_cast<int>(fam),
      static_cast<float>(s), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_reduce_partials_blocked(partial.data_ptr<float>(), nullptr, out.data_ptr<float>(),
                                        m * k, dim(partial, 0), st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K2 (mask None) or K7 on the two-stage route: out (m, k) column j =
// k(x, z)^T diag(mask[:, j]) k(x, z) v[:, j]; mask (n, k); t (n, k) holds
// the first stage, K4 by its plan (znorm, partial1, kc1, n_chunks1 and
// chunk_cols1 as in knm_matvec), the mask multiplying it; xnorm, partial, kc
// and chunk_rows as in knm_t (the plan of the second stage).
void falkon_matvec(const at::Tensor& x, const at::Tensor& z, const at::Tensor& v,
                   const c10::optional<at::Tensor>& mask, at::Tensor& t, at::Tensor& znorm,
                   at::Tensor& partial1, at::Tensor& xnorm, at::Tensor& partial, at::Tensor& out,
                   int64_t kc1, int64_t n_chunks1, int64_t chunk_cols1, int64_t kc,
                   int64_t chunk_rows, int64_t fam, double s, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(v, "v");
  check(t, "t");
  check(partial, "partial");
  check(out, "out");
  if (mask.has_value()) {
    check(*mask, "mask");
    TORCH_CHECK(mask->dim() == 2 && mask->size(0) == x.size(0) && mask->size(1) == v.size(1),
                "mask must be (n, k) = (", x.size(0), ", ", v.size(1), "), got ", mask->sizes());
  }
  if (z.size(0) == 0 || v.size(1) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  if (x.size(0) > 0)
    knm_matvec_launches(x, z, v, mask.has_value() ? mask->data_ptr<float>() : nullptr, znorm,
                        partial1, t, kc1, n_chunks1, chunk_cols1, fam, s, bf16, st);
  knm_t_launches(x, z, t, xnorm, partial, out, kc, chunk_rows, fam, s, bf16, st);
}

// K5: out (n,) = (k(x_i, x_i) - g^T w g) / lamn per row, g = k(x, z) * zmask;
// partial is (max(1, ceil(m / 128)), n) scratch, one row per 128-column tile
// of w.
void rls_score(const at::Tensor& x, const at::Tensor& z, const at::Tensor& w,
               const at::Tensor& zmask, at::Tensor& partial, at::Tensor& out, int64_t fam,
               double s, double lamn, bool bf16) {
  check(x, "x");
  check(z, "z");
  check(w, "w");
  check(zmask, "zmask");
  check(partial, "partial");
  check(out, "out");
  TORCH_CHECK(z.size(0) <= 1024, "rls_score takes at most 1024 centers");
  const int64_t tiles = std::max<int64_t>(1, (z.size(0) + 127) / 128);
  TORCH_CHECK(partial.dim() == 2 && partial.size(0) == tiles && partial.size(1) == x.size(0),
              "partial must be (max(1, ceil(m / 128)), n)");
  if (x.size(0) == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  repro::launch_rls_score_partial(x.data_ptr<float>(), z.data_ptr<float>(), w.data_ptr<float>(),
                                  zmask.data_ptr<float>(), partial.data_ptr<float>(), dim(x, 0),
                                  dim(z, 0), dim(x, 1), static_cast<int>(fam),
                                  static_cast<float>(s), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_rls_score_finish(partial.data_ptr<float>(), x.data_ptr<float>(),
                                 out.data_ptr<float>(), dim(x, 0), dim(x, 1), dim(partial, 0),
                                 static_cast<int>(fam), static_cast<float>(s),
                                 static_cast<float>(lamn), st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K6: out (n,) = rowsum((g w) * g) for g (n, m), w (m, m); partial is
// (ceil(m / 128), n) scratch, one row per 128-column tile of w.
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

// K8: out (b, hq, s, d) = attention of q (b, hq, s, d) over k, v (b, hkv, s, d),
// one dtype for all four.
void flash_attention(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                     at::Tensor& out, bool causal, double scale) {
  check_act(q, "q");
  check_act(k, "k");
  check_act(v, "v");
  check_act(out, "out");
  TORCH_CHECK(k.scalar_type() == q.scalar_type() && v.scalar_type() == q.scalar_type() &&
                  out.scalar_type() == q.scalar_type(),
              "q, k, v and out must share one dtype");
  TORCH_CHECK(q.dim() == 4 && k.sizes() == v.sizes() && k.dim() == 4 && out.sizes() == q.sizes() &&
                  k.size(0) == q.size(0) && k.size(2) == q.size(2) && k.size(3) == q.size(3),
              "need q (b, hq, s, d) and k, v (b, hkv, s, d)");
  TORCH_CHECK(k.size(1) > 0 && q.size(1) % k.size(1) == 0, "hq must be a multiple of hkv");
  TORCH_CHECK(q.size(3) >= 1 && q.size(3) <= 256, "flash_attention takes a head dim of 1 to 256");
  if (q.numel() == 0) return;
  const c10::cuda::CUDAGuard guard(q.device());
  repro::launch_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                dim(q, 0), dim(q, 1), dim(k, 1), dim(q, 2), dim(q, 3),
                                static_cast<float>(scale), causal,
                                q.scalar_type() == at::kBFloat16,
                                at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K9: y (bsz, s, h, p) in x's dtype and state (bsz, h, p, n) fp32 from x, dt
// (bsz, s, h), a (h,) and b, c (bsz, s, n), chunks of `chunk` rows; states
// (bsz, ceil(s / chunk), h, p, n) and decay (bsz, ceil(s / chunk), h) fp32
// scratch; state_heads and scan_heads the heads per block of ssd/ops.py's
// ssd_plan.
void ssd(const at::Tensor& x, const at::Tensor& dt, const at::Tensor& a, const at::Tensor& b,
         const at::Tensor& c, at::Tensor& y, at::Tensor& state, at::Tensor& states,
         at::Tensor& decay, int64_t chunk, int64_t state_heads, int64_t scan_heads) {
  check_act(x, "x");
  check_act(y, "y");
  check(dt, "dt");
  check(a, "a");
  check(b, "b");
  check(c, "c");
  check(state, "state");
  check(states, "states");
  check(decay, "decay");
  TORCH_CHECK(y.scalar_type() == x.scalar_type() && y.sizes() == x.sizes(),
              "y must match x in dtype and shape");
  TORCH_CHECK(x.dim() == 4 && dt.dim() == 3 && dt.size(0) == x.size(0) &&
                  dt.size(1) == x.size(1) && dt.size(2) == x.size(2) && a.dim() == 1 &&
                  a.size(0) == x.size(2) && b.dim() == 3 && b.sizes() == c.sizes() &&
                  b.size(0) == x.size(0) && b.size(1) == x.size(1) && state.dim() == 4 &&
                  state.size(0) == x.size(0) && state.size(1) == x.size(2) &&
                  state.size(2) == x.size(3) && state.size(3) == b.size(2),
              "need x (b, s, h, p), dt (b, s, h), a (h,), b, c (b, s, n), state (b, h, p, n)");
  TORCH_CHECK(chunk >= 1, "chunk must be positive");
  const int bsz = dim(x, 0), s = dim(x, 1), h = dim(x, 2), p = dim(x, 3), n = dim(b, 2);
  const int q = static_cast<int>(chunk), nc = (s + q - 1) / q;
  TORCH_CHECK(states.dim() == 5 && states.size(0) == bsz && states.size(1) == nc &&
                  states.size(2) == h && states.size(3) == p && states.size(4) == n &&
                  decay.dim() == 3 && decay.size(0) == bsz && decay.size(1) == nc &&
                  decay.size(2) == h,
              "need states (b, ceil(s / chunk), h, p, n) and decay (b, ceil(s / chunk), h)");
  TORCH_CHECK(state_heads >= 1 && state_heads <= 64 && (state_heads == 1 || state_heads * p <= 512)
                  && scan_heads >= 1 && scan_heads <= 8,
              "state_heads must be 1, or at most 64 with state_heads * p <= 512; scan_heads 1 to 8");
  TORCH_CHECK(repro::ssd_smem_floats(p, n, q) * 4 <= 232448,
              "ssd: head dim ", p, ", state dim ", n, " and chunk ", q,
              " need more than the 227 KB of shared memory a block may use");
  if (bsz == 0 || s == 0 || h == 0 || p == 0 || n == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  repro::launch_ssd_chunk_state(x.data_ptr(), dt.data_ptr<float>(), a.data_ptr<float>(),
                                b.data_ptr<float>(), states.data_ptr<float>(),
                                decay.data_ptr<float>(), bsz, s, h, p, n, q,
                                static_cast<int>(state_heads), bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_ssd_state_passing(states.data_ptr<float>(), decay.data_ptr<float>(),
                                  state.data_ptr<float>(), bsz, h, p, n, nc, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro::launch_ssd_chunk_scan(x.data_ptr(), dt.data_ptr<float>(), a.data_ptr<float>(),
                               b.data_ptr<float>(), c.data_ptr<float>(), states.data_ptr<float>(),
                               y.data_ptr(), bsz, s, h, p, n, q, static_cast<int>(scan_heads),
                               bf16, st);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gram", &gram, "K1: dense Gram matrix, 16-byte streaming stores on the wide route");
  m.def("knm_matvec", &knm_matvec, "K4: K_nM A, G in registers on the register route");
  m.def("knm_t", &knm_t, "K3: K_nM^T Y, G in registers, fixed-order sum of row chunks");
  m.def("falkon_matvec_fused", &falkon_matvec_fused,
        "K2 or K7 on the cluster route: one Gram build per call");
  m.def("falkon_matvec", &falkon_matvec,
        "K2 or K7 on the two-stage route: K_nM^T diag(mask_j) K_nM v_j per column");
  m.def("rls_score", &rls_score, "K5: fused Eq. 3 score, fixed-order two-stage sum");
  m.def("quadform", &quadform, "K6: rowsum((G W) * G), fixed-order two-stage sum");
  m.def("flash_attention", &flash_attention, "K8: causal or bidirectional GQA attention");
  m.def("ssd", &ssd, "K9: the Mamba-2 SSD chunk scan (chunk states, state passing, chunk scan)");
}
