#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's FALKON and FALKON-BLESS paths on one H100.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without one

Phases (each a plain function, so a CPU test can rehearse them at a tiny size):

  1. probe      card name, capability (must be (9, 0)), nvidia-smi name and
                power limit, CUDA version; TF32 off for matmuls and cuDNN.
  2. build      compile the six CUDA kernels from the sources in this checkout.
  3. parity     each kernel against its plain PyTorch version on the card, at
                ragged shapes, all five kernel families, plus bf16 on the
                gaussian family: K1 gram, K2 falkon_matvec, K3 knm_t, K4
                knm_matvec at n = 70 001, M = 1 000, d = 18 (k vector and 3);
                K5 rls_score at R = 70 001, M in {1, 1000, 1024}; K6 quadform
                at n = 70 001, m in {1 000, 4 097}.
  4. uniform    FalkonRegressor + UniformSampler at the scale of the paper's
                SUSY experiment (d = 18, n_train = 10^6 cut from 5 * 10^6 for
                the time limit, n_test = 10^5, M = 10^4, sigma = 4, lam = 1e-6,
                20 CG iterations), on synthetic data from --seed: fit,
                predict, and predict(return_std=True) (K1 + K6 at M = 10^4);
                the kernels' launch counts are reset just before and read
                just after. The variance is refereed on 4 096 test rows by an
                fp64 TorchBackend: the CUDA variance lies no farther from it
                than the fp32 TorchBackend's, plus 1e-3 of max variance. Then
                refits on the first 65 536 rows with the same centers and the
                same lam: CudaBackend and TorchBackend in fp32, both on the
                card, refereed by a TorchBackend refit in fp64; the CUDA
                refit's predictions must lie no farther from the referee's
                than the fp32 TorchBackend's do, plus 1e-3 of max|pred|, and
                must agree to 1e-3 with a TorchBackend refit given K1's K_MM.
  5. bless      FALKON-BLESS through the front door on the same data:
                FalkonRegressor(sampler=BlessSampler(lam=1e-4, q2=3,
                m_cap=10^4), FitConfig(lam=1e-6, iters=20)), counts reset
                before the fit and read after predict. One line per ladder
                level; the ladder repeated with the same seed must give
                bit-identical centers and weights; on the final level's
                center set the CUDA scores of 4 096 candidates must agree
                with TorchBackend's.
  6. times      each kernel at the shapes the main paths gave it, against its
                plain version there (tolerance checked again), timed with CUDA
                events beside its bound and a PyTorch yardstick call: K5 at
                the largest ladder level with at most 1 024 centers, K6 at the
                predictive-variance shape (10^5 x 10^4) and at the largest
                ladder level above 1 024 centers, if there is one.

Tolerances: Gram 2e-5 absolute; K_nM contractions and the quadratic form
1e-4 * max|ref|; RLS scores 5e-4 relative + 5e-5 (tests/test_backend.py's
form); bf16 3e-2 * max|ref|; end-to-end predictions and variances 1e-3 *
max (beyond the fp32 TorchBackend's own distance from the fp64 referee).
Any failed phase exits non-zero. The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

FAMILIES = ["gaussian", "laplacian", "linear", "matern32", "cauchy"]
GRAM_TOL = 2e-5
KNM_TOL = 1e-4
SCORE_RTOL, SCORE_ATOL = 5e-4, 5e-5
BF16_TOL = 3e-2
E2E_TOL = 1e-3
#: NVIDIA H100 SXM data-sheet peaks (dense, non-tensor fp32; HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: kernel name -> (CUDA source, the TPU kernel it replaces).
KERNELS = {
    "gram": ("src/repro_torch/kernels/gram/gram.cu",
             "src/repro/kernels/gram/gram.py:45"),
    "falkon_matvec": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                      "src/repro/kernels/falkon_matvec/falkon_matvec.py:93"),
    "knm_t": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
              "src/repro/kernels/falkon_matvec/falkon_matvec.py:184"),
    "knm_matvec": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                   "src/repro/kernels/falkon_matvec/falkon_matvec.py:221"),
    "rls_score": ("src/repro_torch/kernels/rls_score/rls_score.cu",
                  "src/repro/kernels/rls_score/rls_score.py:65"),
    "quadform": ("src/repro_torch/kernels/quadform/quadform.cu",
                 "src/repro/kernels/quadform/quadform.py:51"),
}
#: the kernels each main path must launch (K6 also on the BLESS path when a
#: ladder level holds more than 1 024 distinct centers).
UNIFORM_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec", "quadform")
BLESS_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec", "rls_score")


class PhaseError(RuntimeError):
    """A phase found a wrong result."""


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. probe / 2. build
# ---------------------------------------------------------------------------


def probe() -> dict:
    """Card facts; raises unless a Hopper (9, 0) card is present."""
    if not torch.cuda.is_available():
        raise PhaseError("no CUDA device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"name": name, "capability": list(cap), "nvidia_smi": smi,
            "cuda": torch.version.cuda, "torch": torch.__version__,
            "count": torch.cuda.device_count(),
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"probe: {json.dumps(info)}")
    log(smi)
    if tuple(cap) != (9, 0):
        raise PhaseError(f"expected compute capability (9, 0), got {cap}")
    return info


def build_kernels() -> dict:
    """Compile every kernel (one cpp_extension.load; ninja runs the
    compilers in parallel) and print the seconds it took."""
    from repro_torch.kernels import build

    info = build.build()
    log(f"build: {info['seconds']:.1f} s (torch.utils.cpp_extension.load of "
        f"{', '.join(build.SOURCES)})")
    return info


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_data(n: int, d: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """SUSY-shaped synthetic classification data made on ``device``: x ~ N(0, I_d),
    y = sign(tanh(x.w + 0.7 sin(2 x_0) x_1) + 0.3 noise) in {-1, +1} (the
    ground-truth rule of benchmarks/run.py ``_classif``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    w = torch.randn((d,), generator=g, device=device)
    noise = torch.randn((n,), generator=g, device=device)
    margin = torch.tanh(x @ w + 0.7 * torch.sin(2 * x[:, 0]) * x[:, 1])
    y = torch.sign(margin + 0.3 * noise)
    return x, torch.where(y == 0, torch.ones_like(y), y)


# ---------------------------------------------------------------------------
# 3. kernel parity at ragged shapes
# ---------------------------------------------------------------------------


def _err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max |ref|)."""
    if not bool(torch.all(torch.isfinite(out))):
        return math.inf, float(ref.abs().max())
    return float((out - ref).abs().max()), float(ref.abs().max())


def _score_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max of |out - ref| / (SCORE_ATOL + SCORE_RTOL |ref|)):
    the scores agree when the second is at most 1."""
    if not bool(torch.all(torch.isfinite(out))):
        return math.inf, math.inf
    diff = (out - ref).abs()
    return float(diff.max()), float((diff / (SCORE_ATOL + SCORE_RTOL * ref.abs())).max())


def score_inputs(device, r: int, m: int, d: int, kind: str, sigma: float, seed: int):
    """Candidates x (r, d), a padded center set z (m, d) whose last tenth is
    invalid, and the inverse W = (K_JJ * mask + diag(reg))^-1 with reg =
    lam n A (lam n = 50, A in [0.5, 1.5)): the operands K5 and K6 get."""
    from repro_torch.kernels import gram_ops as go

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((r, d), generator=g, device=device)
    z = torch.randn((m, d), generator=g, device=device)
    mask = (torch.arange(m, device=device) < max(1, m - m // 10)).float()
    lamn = 50.0
    reg = torch.where(mask > 0, lamn * (0.5 + torch.rand((m,), generator=g, device=device)),
                      torch.ones((m,), device=device))
    kjj = go.gram_reference(z, z, sigma, kind=kind) * (mask[:, None] * mask[None, :])
    w = torch.cholesky_solve(torch.eye(m, device=device),
                             torch.linalg.cholesky(kjj + torch.diag(reg)))
    return x, z, w, mask, lamn


def kernel_parity(device, *, n: int = 70_001, m: int = 1_000, d: int = 18, k: int = 3,
                  sigma: float = 4.0, seed: int = 0, score_ms=(1, 1_000, 1_024),
                  quad_ms=(1_000, 4_097)) -> dict:
    """Every kernel against its plain version on ``device``; returns
    {kernel: max abs error over the fp32 cases}; raises past a tolerance."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go
    from repro_torch.kernels import quadform_ops as qo
    from repro_torch.kernels import rls_score_ops as ro

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    z = torch.randn((m, d), generator=g, device=device)
    vp = torch.randn((m, k), generator=g, device=device)
    yp = torch.randn((n, k), generator=g, device=device)
    worst: dict[str, float] = {}
    bad = []

    def check(name, kind, bf16, shape, out, ref):
        tag = f"{name}/{kind}{'/bf16' if bf16 else ''}/{shape}"
        if out.shape != ref.shape:
            bad.append(f"{tag}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
            return
        err, scale = _err(out, ref)
        if bf16:
            tol = BF16_TOL * max(scale, 1.0) if name == "gram" else BF16_TOL * scale
        else:
            tol = GRAM_TOL if name == "gram" else KNM_TOL * scale
            worst[name] = max(worst.get(name, 0.0), err)
        log(f"parity {tag}: max_abs_err={err:.3e} tol={tol:.3e} max|ref|={scale:.3e}")
        if not err <= tol:
            bad.append(f"{tag}: {err:.3e} > {tol:.3e}")

    for kind in FAMILIES:
        for bf16 in ([False, True] if kind == "gaussian" else [False]):
            kw = dict(kind=kind, bf16=bf16)
            check("gram", kind, bf16, f"{n}x{m}", go.gram(x, z, sigma, **kw),
                  go.gram_reference(x, z, sigma, **kw))
            for v, y, shape in ((vp[:, 0], yp[:, 0], "vec"), (vp, yp, f"k={k}")):
                check("falkon_matvec", kind, bf16, shape, fo.falkon_matvec(x, z, v, sigma, **kw),
                      fo.falkon_matvec_reference(x, z, v, sigma, **kw))
                check("knm_t", kind, bf16, shape, fo.knm_t(x, z, y, sigma, **kw),
                      fo.knm_t_reference(x, z, y, sigma, **kw))
                check("knm_matvec", kind, bf16, shape, fo.knm_matvec(x, z, v, sigma, **kw),
                      fo.knm_matvec_reference(x, z, v, sigma, **kw))
            sync(device)

    # K5 and K6 on the operands the backend forms: a masked center buffer and
    # the explicit inverse of its regularized K_JJ.
    for kind in FAMILIES:
        for bf16 in ([False, True] if kind == "gaussian" else [False]):
            for mm in score_ms:
                xs, zs, w, mask, lamn = score_inputs(device, n, mm, d, kind, sigma, seed + mm)
                out = ro.rls_score(xs, zs, w, mask, lamn, sigma, kind=kind, bf16=bf16)
                ref = ro.rls_score_reference(xs, zs, w, mask, lamn, sigma, kind=kind, bf16=bf16)
                tag = f"rls_score/{kind}{'/bf16' if bf16 else ''}/{n}x{mm}"
                if bf16:
                    check("rls_score", kind, bf16, f"{n}x{mm}", out, ref)
                    continue
                err, ratio = _score_err(out, ref)
                worst["rls_score"] = max(worst.get("rls_score", 0.0), err)
                log(f"parity {tag}: max_abs_err={err:.3e} max err/(atol+rtol|ref|)={ratio:.3f}")
                if not ratio <= 1.0:
                    bad.append(f"{tag}: scores differ ({ratio:.3f} of the tolerance)")
            for mm in quad_ms:
                xs, zs, w, mask, _ = score_inputs(device, n, mm, d, kind, sigma, seed + mm)
                gq = go.gram(xs, zs, sigma, kind=kind) * mask[None, :]
                check("quadform", kind, bf16, f"{n}x{mm}", qo.quadform(gq, w, bf16=bf16),
                      qo.quadform_reference(gq, w, bf16=bf16))
                del gq
            sync(device)
    if bad:
        raise PhaseError("kernel parity failed: " + "; ".join(bad))
    return worst


# ---------------------------------------------------------------------------
# 4. end to end
# ---------------------------------------------------------------------------


def end_to_end(device, *, n_train: int = 1_000_000, n_test: int = 100_000, m: int = 10_000,
               d: int = 18, iters: int = 20, sigma: float = 4.0, lam: float = 1e-6,
               refit_rows: int = 65_536, referee_rows: int = 4_096, seed: int = 0,
               max_error: float = 0.2) -> dict:
    """Fit, predict and predict with std through the front door with the
    launch counts reset just before and read just after; the variance
    referee; then the CudaBackend / TorchBackend refit agreement. Returns
    the metrics and the tensors the later phases reuse."""
    from repro_torch import kernels
    from repro_torch.api import FalkonRegressor, FitConfig, UniformSampler
    from repro_torch.core import CudaBackend, make_preconditioner

    x, y = make_data(n_train + n_test, d, seed, device)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    est = FalkonRegressor(kernel="gaussian", sigma=sigma,
                          sampler=UniformSampler(m=m, weights="identity", replace=False),
                          config=FitConfig(lam=lam, iters=iters, seed=seed, device=str(device)))
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(xtr, ytr)
    sync(device)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = est.predict(xte)
    sync(device)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred_std, std = est.predict(xte, return_std=True)
    sync(device)
    predict_std_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None

    if pred.shape != (n_test,) or not bool(torch.all(torch.isfinite(pred))):
        raise PhaseError(f"predictions: shape {tuple(pred.shape)}, finite "
                         f"{bool(torch.all(torch.isfinite(pred)))}")
    test_error = float(torch.mean((torch.sign(pred) != yte).float()))
    reduction = float(est.model_.diagnostics.reduction.max())
    res = {"n_train": n_train, "n_test": n_test, "m": m, "d": d, "iters": iters,
           "fit_s": fit_s, "predict_s": predict_s, "predict_std_s": predict_std_s,
           "test_error": test_error, "cg_residual_reduction": reduction, "launches": launches,
           "peak_bytes": peak, "knm_bytes": 4 * n_train * m}
    log(f"end_to_end: {json.dumps(res)}")
    if not torch.equal(pred_std, pred):
        raise PhaseError("predict(return_std=True) changed the predictions")
    res["variance"] = variance_referee(est.model_, xte, std, referee_rows)
    if not test_error < max_error:
        raise PhaseError(f"test error {test_error:.4f} is not below {max_error}")
    if not reduction < 1e-2:
        raise PhaseError(f"CG reduced the squared residual only to {reduction:.3e}")
    if peak is not None and not peak < 0.25 * res["knm_bytes"]:
        raise PhaseError(f"peak device memory {peak} B is not far below K_nM's "
                         f"{res['knm_bytes']} B")
    if torch.device(device).type == "cuda":
        missing = [name for name in UNIFORM_PATH if launches[name] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the uniform path: {missing}")

    # Where the fit's time goes outside the kernels: the sampler (host draw
    # plus the gather of the centers) and the Def. 2 preconditioner (eigh of
    # the M x M K_MM), each timed once more on its own after the fit.
    t0 = time.perf_counter()
    cs = est.sampler.sample(seed, xtr, est.kernel)
    z = xtr[cs.idx[:m].to(xtr.device)]
    sync(device)
    sample_s = time.perf_counter() - t0
    kmm = CudaBackend().gram_block(est.kernel, z, z)
    sync(device)
    t0 = time.perf_counter()
    make_preconditioner(est.kernel, z, torch.ones(m, device=z.device), lam, n_train, kmm=kmm)
    sync(device)
    res["breakdown"] = {"sample_s": sample_s, "preconditioner_s": time.perf_counter() - t0}
    del kmm, z
    log(f"fit breakdown: {json.dumps(res['breakdown'])}")

    rows = min(refit_rows, n_train)
    res["refit"] = refit_agreement(est.kernel, xtr[:rows], ytr[:rows], est.centers_,
                                   est.a_diag_, xte, lam, iters)
    res["tensors"] = {"x": xtr, "z": est.centers_, "xte": xte, "y": ytr, "yte": yte,
                      "alpha": est.model_.alpha, "lamn": lam * n_train}
    return res


def variance_referee(model, xte, std, rows: int) -> dict:
    """The CUDA predictive variance (std**2 of ``predict(return_std=True)``)
    against an fp64 TorchBackend referee on the first ``rows`` test rows.

    Gates: every variance finite and >= 0; the CUDA variance no farther from
    the referee than the fp32 TorchBackend's, plus E2E_TOL * max variance.
    """
    from repro_torch.core import FalkonModel, TorchBackend

    var = std.double() ** 2
    sub = xte[:rows]
    t32 = model.predictive_variance(sub, backend=TorchBackend()).double()
    m64 = FalkonModel(centers=model.centers.double(), alpha=model.alpha.double(),
                      kernel=model.kernel, lam=model.lam, n_train=model.n_train,
                      a_diag=model.a_diag.double())
    t64 = m64.predictive_variance(sub.double(), backend=TorchBackend())
    # the CUDA path's composition in plain fp32 torch (explicit W, then
    # rowsum((G W) * G)): reported, not gated, to tell the explicit inverse's
    # rounding apart from K1's and K6's
    kern = model.kernel
    lamn = model.lam * model.n_train
    kmm = kern.cross(model.centers, model.centers) + torch.diag(lamn * model.a_diag.float())
    w = torch.cholesky_solve(torch.eye(kmm.shape[0], device=kmm.device),
                             torch.linalg.cholesky(kmm))
    g = kern.cross(sub, model.centers)
    tw = torch.clamp(kern.diag(sub) - torch.sum((g @ w) * g, dim=1), min=0.0).double()
    del kmm, w, g
    scale = float(t64.abs().max())
    res = {"rows": sub.shape[0], "max_var_fp64": scale,
           "cuda_fp64": float((var[:rows] - t64).abs().max()) / scale,
           "torch_fp64": float((t32 - t64).abs().max()) / scale,
           "torch_explicit_w_fp64": float((tw - t64).abs().max()) / scale,
           "min_var": float(var.min()), "finite": bool(torch.all(torch.isfinite(var)))}
    log(f"variance cuda vs torch, fp64 referee: {json.dumps(res)}")
    if not res["finite"] or not res["min_var"] >= 0.0:
        raise PhaseError(f"predictive variances: finite {res['finite']}, min {res['min_var']}")
    if not res["cuda_fp64"] <= res["torch_fp64"] + E2E_TOL:
        raise PhaseError(f"the CUDA variance is {res['cuda_fp64']:.3e} from the fp64 referee, "
                         f"farther than TorchBackend's ({res['torch_fp64']:.3e}) + {E2E_TOL}")
    return res


def refit_agreement(kern, x, y, z, a_diag, xte, lam: float, iters: int) -> dict:
    """CudaBackend against TorchBackend on the same rows and centers at the
    fit's own lam, with an fp64 refit as the referee.

    Four refits, each predicted on ``xte``:
      cuda      CudaBackend (K1-K4), fp32
      torch     TorchBackend, fp32
      torch_k1  TorchBackend, fp32, but K_MM from K1: the kernels' K_MM with
                torch's K_nM sweeps, which splits the K_MM rounding from the rest
      fp64      TorchBackend on fp64 copies of the same inputs: the referee
    Each distance is a max abs difference over max |fp64 prediction|. The
    gates: the CUDA refit is no farther from the referee than the fp32
    TorchBackend refit is, plus E2E_TOL; and on one K_MM (K1's) the CUDA
    sweeps and torch's agree to E2E_TOL ("cuda_torch_k1"). "cuda_torch", the
    two fp32 paths each on its own K_MM, is reported beside them: the fp32
    solve at this lam amplifies K_MM's last-bit rounding past E2E_TOL. K2
    and K3 are held against their plain versions at the refit's shape too.
    """
    from repro_torch.core import CudaBackend, TorchBackend, falkon_fit
    from repro_torch.kernels import falkon_matvec_ops as fo

    @dataclasses.dataclass(frozen=True)
    class TorchBackendK1Gram(TorchBackend):
        def gram_block(self, kernel, xa, za):
            return CudaBackend().gram_block(kernel, xa, za)

    def refit(backend, dtype=torch.float32):
        model = falkon_fit(kern, x.to(dtype), y.to(dtype), z.to(dtype), lam,
                           a_diag=a_diag.to(dtype), iters=iters, backend=backend)
        return model, model.predict(xte.to(dtype), backend=backend)

    cuda_model, cuda = refit(CudaBackend())
    preds = {"cuda": cuda, "torch": refit(TorchBackend())[1],
             "torch_k1": refit(TorchBackendK1Gram())[1],
             "fp64": refit(TorchBackend(), torch.float64)[1]}
    sync(x.device)
    scale = float(preds["fp64"].abs().max())

    def dist(a, b):
        return float((preds[a].double() - preds[b].double()).abs().max()) / scale

    res = {"rows": x.shape[0], "lam": lam, "max_abs_pred_fp64": scale,
           "cuda_fp64": dist("cuda", "fp64"), "torch_fp64": dist("torch", "fp64"),
           "torch_k1_fp64": dist("torch_k1", "fp64"), "cuda_torch": dist("cuda", "torch"),
           "torch_k1_torch": dist("torch_k1", "torch"), "cuda_torch_k1": dist("cuda", "torch_k1")}
    v = cuda_model.alpha
    kw = dict(sigma=kern.sigma, kind=kern.name)
    parity = {"falkon_matvec": (fo.falkon_matvec(x, z, v, **kw),
                                fo.falkon_matvec_reference(x, z, v, **kw)),
              "knm_t": (fo.knm_t(x, z, y, **kw), fo.knm_t_reference(x, z, y, **kw))}
    bad = []
    for name, (out, ref) in parity.items():
        err, ref_scale = _err(out, ref)
        res[f"parity_{name}"] = {"max_abs_err": err, "tol": KNM_TOL * ref_scale}
        if not err <= KNM_TOL * ref_scale:
            bad.append(f"{name} at the refit's shape: {err:.3e} > {KNM_TOL * ref_scale:.3e}")
    log(f"refit cuda vs torch, fp64 referee: {json.dumps(res)}")
    if not all(math.isfinite(float(p.abs().max())) for p in preds.values()):
        bad.append("a refit's predictions are not finite")
    if not res["cuda_fp64"] <= res["torch_fp64"] + E2E_TOL:
        bad.append(f"the CudaBackend refit is {res['cuda_fp64']:.3e} from the fp64 referee, "
                   f"farther than the TorchBackend refit ({res['torch_fp64']:.3e}) + {E2E_TOL}")
    if not res["cuda_torch_k1"] <= E2E_TOL:
        bad.append(f"on K1's K_MM the CudaBackend and TorchBackend refits differ by "
                   f"{res['cuda_torch_k1']:.3e} > {E2E_TOL}")
    if bad:
        raise PhaseError("refit agreement failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# 5. FALKON-BLESS at full width
# ---------------------------------------------------------------------------


def level_recorder(inner):
    """A backend that runs ``inner`` and notes, for each ``rls_scores`` call
    (one per ladder level with centers), its operands and the launches it
    made. It adds bookkeeping only, so a ladder run on it must repeat the
    fit's own ladder bit for bit."""
    from repro_torch import kernels
    from repro_torch.core import Backend

    @dataclasses.dataclass(frozen=True)
    class LevelRecorder(Backend):
        calls: list = dataclasses.field(default_factory=list, compare=False, hash=False)

        def rls_scores(self, kernel, x_cand, z, z_mask, reg, lamn):
            before = kernels.launch_counts()
            out = inner.rls_scores(kernel, x_cand, z, z_mask, reg, lamn)
            after = kernels.launch_counts()
            self.calls.append({"r": x_cand.shape[0], "dbuf": z.shape[0],
                               "launches": {k: after[k] - before[k] for k in after},
                               "args": (x_cand, z, z_mask, reg, float(lamn))})
            return out

    return LevelRecorder()


def bless_end_to_end(device, t: dict, *, sigma: float = 4.0, lam_bless: float = 1e-4,
                     q2: float = 3.0, m_cap: int = 10_000, lam: float = 1e-6, iters: int = 20,
                     seed: int = 0, score_rows: int = 4_096, max_error: float = 0.2) -> dict:
    """FALKON-BLESS through the front door on phase 4's data, with the launch
    counts reset just before the fit and read just after predict. Then the
    ladder once more with the same seed on a recording backend: one line per
    level, its time (the sampler's share of the fit), and the gate that it
    repeats the fit's centers and weights bit for bit. Then the final level's
    scores of ``score_rows`` candidates, CudaBackend against TorchBackend."""
    from repro_torch import kernels
    from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig
    from repro_torch.core import CudaBackend, TorchBackend, approx_rls, make_preconditioner
    from repro_torch.core.bless import _bucket
    from repro_torch.kernels import rls_score_ops as ro

    xtr, ytr, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    n_train = xtr.shape[0]
    on_card = torch.device(device).type == "cuda"
    est = FalkonRegressor(kernel="gaussian", sigma=sigma,
                          sampler=BlessSampler(lam=lam_bless, q2=q2, m_cap=m_cap),
                          config=FitConfig(lam=lam, iters=iters, seed=seed, device=str(device)))
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(xtr, ytr)
    sync(device)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = est.predict(xte)
    sync(device)
    predict_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    m = int(est.center_set_.count)

    if pred.shape != yte.shape or not bool(torch.all(torch.isfinite(pred))):
        raise PhaseError(f"FALKON-BLESS predictions: shape {tuple(pred.shape)}, finite "
                         f"{bool(torch.all(torch.isfinite(pred)))}")
    test_error = float(torch.mean((torch.sign(pred) != yte).float()))
    reduction = float(est.model_.diagnostics.reduction.max())

    # the ladder again, same seed, same backend, recorded level by level
    rec = level_recorder(est._backend())
    sync(device)
    t0 = time.perf_counter()
    ladder = est.sampler.ladder(seed, xtr, est.kernel, backend=rec)
    sync(device)
    sample_s = time.perf_counter() - t0
    repeat_equal = (torch.equal(ladder.final.centers.idx, est.center_set_.idx)
                    and torch.equal(ladder.final.centers.weight, est.center_set_.weight))
    # where the rest of the fit goes: K2 at the fit's M (one CG iteration's
    # quadratic op) and the Def. 2 preconditioner, each timed once more, warm
    z = est.centers_
    kmm = CudaBackend().gram_block(est.kernel, z, z)
    sync(device)
    t0 = time.perf_counter()
    make_preconditioner(est.kernel, z, est.a_diag_, lam, n_train, kmm=kmm)
    sync(device)
    precond_s = time.perf_counter() - t0
    del kmm
    k2_ms = None
    if on_card:
        quad = CudaBackend().knm_quadratic(est.kernel, xtr, z)
        k2_ms = _cuda_ms(lambda: quad(est.model_.alpha), 3)
    levels = []
    for h, lvl in enumerate(ladder.levels):
        call = rec.calls[h - 1] if h >= 1 else None
        row = {"lam": lvl.lam, "r_h": lvl.r_h, "rbuf": _bucket(lvl.r_h), "m_h": lvl.m_h,
               "mbuf": lvl.centers.idx.shape[0], "dbuf": call["dbuf"] if call else 0,
               "d_h": lvl.d_h,
               "k5": call["launches"]["rls_score"] if call else 0,
               "k6": call["launches"]["quadform"] if call else 0}
        levels.append(row)
        log(f"bless level {h}: {json.dumps(row)}")
    above = [c for c in rec.calls if c["dbuf"] > ro.MAX_FUSED_M]
    log(f"bless levels scored against more than {ro.MAX_FUSED_M} distinct centers: "
        f"{len(above)}")

    # the final level's own center set: CUDA scores against TorchBackend's
    final = ladder.final
    cand = xtr[:score_rows]
    cmask = torch.ones((cand.shape[0],), dtype=torch.bool, device=cand.device)
    s_cuda = approx_rls(est.kernel, cand, cmask, xtr, final.centers, final.lam,
                        backend=CudaBackend())
    s_torch = approx_rls(est.kernel, cand, cmask, xtr, final.centers, final.lam,
                         backend=TorchBackend())
    score_err, score_ratio = _score_err(s_cuda, s_torch)

    res = {"n_train": n_train, "m": m, "mbuf": est.center_set_.idx.shape[0],
           "lam_bless": lam_bless, "lam": lam, "iters": iters, "fit_s": fit_s,
           "sample_s": sample_s, "sampler_share_of_fit": sample_s / fit_s,
           "preconditioner_s": precond_s, "falkon_matvec_ms": k2_ms,
           "predict_s": predict_s, "test_error": test_error,
           "cg_residual_reduction": reduction, "launches": launches, "peak_bytes": peak,
           "knm_bytes": 4 * n_train * m, "repeat_bit_identical": repeat_equal,
           "levels_above_1024": len(above), "final_score_max_abs_err": score_err,
           "final_score_err_over_tol": score_ratio}
    log(f"bless end_to_end: {json.dumps(res)}")
    bad = []
    if not test_error < max_error:
        bad.append(f"test error {test_error:.4f} is not below {max_error}")
    if not reduction < 1e-2:
        bad.append(f"CG reduced the squared residual only to {reduction:.3e}")
    if peak is not None and not peak < 0.25 * res["knm_bytes"]:
        bad.append(f"peak device memory {peak} B is not far below K_nM's {res['knm_bytes']} B")
    if on_card:
        need = BLESS_PATH + (("quadform",) if above else ())
        missing = [name for name in need if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the FALKON-BLESS path: {missing}")
    if not repeat_equal:
        bad.append("the ladder repeated with the same seed gave other centers or weights")
    if not score_ratio <= 1.0:
        bad.append(f"final-level scores: CUDA vs TorchBackend {score_ratio:.3f} of the tolerance")
    if bad:
        raise PhaseError("FALKON-BLESS failed: " + "; ".join(bad))

    def largest(calls):
        return max(calls, key=lambda c: (c["dbuf"], c["r"]))["args"] if calls else None

    res["levels"] = levels
    res["tensors"] = {"k5": largest([c for c in rec.calls if c["dbuf"] <= ro.MAX_FUSED_M]),
                      "k6_ladder": largest(above)}
    return res


# ---------------------------------------------------------------------------
# 6. kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def bound(name: str, n: int, m: int, d: int, k: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for one call.

    Bytes: each input read once, each output written once (fp32). Operations:
    the Gram values computed once, 2d for x.z plus 3 for the distance
    (add, fma, clamp) plus 2 for the gaussian epilogue (mul, exp), and 2 per
    multiply-add of each contraction against k columns (falkon_matvec has
    two). K5 (``rls_score``, n candidates against m centers) reads x, z, W,
    the mask and K_ii and writes the scores; it computes the Gram values, 2
    per multiply-add of G W, and 2 per element of the row sum with G. K6
    (``quadform``, G (n, m)) reads G and W and writes n values; 2 n m^2 + 2 n m
    operations. Over the fp32 peak and the HBM rate of the data sheet.
    """
    gram_ops = n * m * (2 * d + 5)
    if name == "gram":
        nbytes, ops = 4 * (n * d + m * d + n * m), gram_ops
    elif name == "falkon_matvec":
        nbytes, ops = 4 * (n * d + m * d + 2 * m * k), gram_ops + 4 * n * m * k
    elif name == "knm_t":
        nbytes, ops = 4 * (n * d + m * d + n * k + m * k), gram_ops + 2 * n * m * k
    elif name == "knm_matvec":
        nbytes, ops = 4 * (n * d + m * d + m * k + n * k), gram_ops + 2 * n * m * k
    elif name == "rls_score":
        nbytes = 4 * (n * d + m * d + m * m + m + 2 * n)
        ops = gram_ops + 2 * n * m * m + 2 * n * m
    elif name == "quadform":
        nbytes, ops = 4 * (n * m + m * m + n), 2 * n * m * m + 2 * n * m
    else:
        raise ValueError(name)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_call(name: str, x, z, v, s: float, block: int = 16_384, w=None, mask=None,
                  lamn: float = 1.0):
    """One PyTorch yardstick for the same function (cdist + exp + matmul),
    row-blocked where the whole K_nM would not fit. Never used by the port.
    For K5 it is the Gram + ``torch.matmul`` chain (1 - rowsum((G W) * G)) /
    lam n with G masked (K_ii = 1 for the gaussian); for K6, with ``x`` the
    given G, rowsum((G W) * G)."""
    def g(xb):
        return torch.exp(-torch.cdist(xb, z).square() * s)
    if name == "gram":
        return g(z)
    if name == "quadform":
        return torch.sum((x @ w) * x, dim=1)
    if name == "rls_score":
        gm = g(x) * mask[None, :]
        return (1.0 - torch.sum((gm @ w) * gm, dim=1)) / lamn
    if name == "knm_matvec":
        return torch.cat([g(x[i:i + block]) @ v for i in range(0, x.shape[0], block)])
    out = torch.zeros((z.shape[0],) + tuple(v.shape[1:]), device=x.device)
    for i in range(0, x.shape[0], block):
        gb = g(x[i:i + block])
        out += gb.T @ (v[i:i + block] if name == "knm_t" else gb @ v)
    return out


def _cuda_ms(fn, repeats: int) -> float:
    """Mean ms per call over ``repeats`` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def main_path_calls(t: dict, sigma: float, bless_t: dict):
    """(name, n, m, d, k, kernel call, plain call, library call) for each kernel
    at the shapes the main paths gave it: K1 builds K_MM, K2 and K3 run on
    the training rows with a vector, K4 predicts the test rows, K5 scores the
    largest ladder level with at most 1 024 centers, K6 contracts the test
    rows' Gram block against W at M = 10^4 (the predictive variance), and
    "quadform@ladder" is K6 at the largest ladder level above 1 024 centers
    (timed and logged, not part of the kernels record)."""
    from repro_torch.core import CudaBackend, make_kernel
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go
    from repro_torch.kernels import quadform_ops as qo
    from repro_torch.kernels import rls_score_ops as ro

    x, z, xte, y, alpha = t["x"], t["z"], t["xte"], t["y"], t["alpha"]
    n, d = x.shape
    m = z.shape[0]
    s = 1.0 / (2.0 * sigma ** 2)
    v = alpha
    kern = make_kernel("gaussian", sigma=sigma)
    # the operands as CudaBackend forms them: mask as fp32 and the explicit W
    inverse = CudaBackend()._inverse
    ones = torch.ones((m,), device=z.device)
    _, w_var = inverse(kern, z, ones > 0, t["lamn"] * ones)
    g_var = go.gram(xte, z, sigma)
    xs, zs, ms, rs, lamn = bless_t["k5"]
    mk5, wk5 = inverse(kern, zs, ms, rs)
    extra = []
    if bless_t["k6_ladder"] is not None:
        xl, zl, ml, rl, _ = bless_t["k6_ladder"]
        mk6, wk6 = inverse(kern, zl, ml, rl)
        gl = go.gram(xl, zl, sigma) * mk6[None, :]
        extra.append(("quadform@ladder", xl.shape[0], zl.shape[0], d, 1,
                      lambda: qo.quadform(gl, wk6), lambda: qo.quadform_reference(gl, wk6),
                      lambda: _library_call("quadform", gl, None, None, s, w=wk6)))
    return [
        ("gram", m, m, d, m, lambda: go.gram(z, z, sigma),
         lambda: go.gram_reference(z, z, sigma), lambda: _library_call("gram", z, z, None, s)),
        ("falkon_matvec", n, m, d, 1, lambda: fo.falkon_matvec(x, z, v, sigma),
         lambda: fo.falkon_matvec_reference(x, z, v, sigma),
         lambda: _library_call("falkon_matvec", x, z, v, s)),
        ("knm_t", n, m, d, 1, lambda: fo.knm_t(x, z, y, sigma),
         lambda: fo.knm_t_reference(x, z, y, sigma),
         lambda: _library_call("knm_t", x, z, y, s)),
        ("knm_matvec", xte.shape[0], m, d, 1, lambda: fo.knm_matvec(xte, z, v, sigma),
         lambda: fo.knm_matvec_reference(xte, z, v, sigma),
         lambda: _library_call("knm_matvec", xte, z, v, s)),
        ("rls_score", xs.shape[0], zs.shape[0], d, 1,
         lambda: ro.rls_score(xs, zs, wk5, mk5, lamn, sigma),
         lambda: ro.rls_score_reference(xs, zs, wk5, mk5, lamn, sigma),
         lambda: _library_call("rls_score", xs, zs, None, s, w=wk5, mask=mk5, lamn=lamn)),
        ("quadform", xte.shape[0], m, d, 1, lambda: qo.quadform(g_var, w_var),
         lambda: qo.quadform_reference(g_var, w_var),
         lambda: _library_call("quadform", g_var, None, None, s, w=w_var)),
    ] + extra


def main_path_parity(calls) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    errs = {}
    bad = []
    for name, n, m, d, k, kern, plain, _ in calls:
        out, ref = kern(), plain()
        if name == "rls_score":
            err, ratio = _score_err(out, ref)
            ok = ratio <= 1.0
            log(f"parity@main {name} (n={n}, M={m}, d={d}): max_abs_err={err:.3e} "
                f"max err/(atol+rtol|ref|)={ratio:.3f}")
        else:
            err, scale = _err(out, ref)
            tol = GRAM_TOL if name == "gram" else KNM_TOL * scale
            ok = err <= tol
            log(f"parity@main {name} (n={n}, M={m}, d={d}): max_abs_err={err:.3e} tol={tol:.3e}")
        errs[name] = err
        if not ok:
            bad.append(f"{name}: {err:.3e} out of tolerance")
        del out, ref
    if bad:
        raise PhaseError("main-path parity failed: " + "; ".join(bad))
    return errs


def kernel_times(calls, *, repeats: int = 5, plain_repeats: int = 2) -> dict:
    """CUDA-event times of each kernel, its plain version and the yardstick."""
    times = {}
    for name, n, m, d, k, kern, plain, library in calls:
        b_ms, b_by = bound(name.split("@")[0], n, m, d, k)
        times[name] = {"ms": _cuda_ms(kern, repeats), "plain_ms": _cuda_ms(plain, plain_repeats),
                       "library_ms": _cuda_ms(library, plain_repeats),
                       "bound_ms": b_ms, "bound_by": b_by, "shape": [n, m, d, k]}
        log(f"times {name}: {json.dumps(times[name])}")
    return times


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and the centers")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        info = probe()
        build_kernels()
        parity_worst = kernel_parity("cuda", seed=args.seed)
        e2e = end_to_end("cuda", seed=args.seed)
        tensors = e2e.pop("tensors")
        fb = bless_end_to_end("cuda", tensors, seed=args.seed)
        calls = main_path_calls(tensors, sigma=4.0, bless_t=fb.pop("tensors"))
        errs = main_path_parity(calls)
        times = kernel_times(calls)
    except PhaseError as e:
        print(f"chip_smoke: FAIL {e}", file=sys.stderr)
        return 1
    # launches: the two main paths' counts added (each reset just before its path)
    launches = {name: e2e["launches"][name] + fb["launches"][name] for name in KERNELS}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name in KERNELS]}
    kernel_s = sum(e2e["launches"][n] * times[n]["ms"] for n in ("gram", "falkon_matvec",
                                                                  "knm_t")) / 1e3
    log(f"uniform fit: {e2e['fit_s']:.3f} s, of which kernels {kernel_s:.3f} s (launches x ms), "
        f"preconditioner {e2e['breakdown']['preconditioner_s']:.3f} s, sampler "
        f"{e2e['breakdown']['sample_s']:.3f} s; predict {e2e['predict_s']:.4f} s, with std "
        f"{e2e['predict_std_s']:.4f} s")
    log(f"FALKON-BLESS fit: {fb['fit_s']:.3f} s at M = {fb['m']}, sampler (repeat) "
        f"{fb['sample_s']:.3f} s, K2 {fb['launches']['falkon_matvec']} x "
        f"{fb['falkon_matvec_ms']:.3f} ms, preconditioner {fb['preconditioner_s']:.3f} s, "
        f"predict {fb['predict_s']:.4f} s; launches uniform path "
        f"{json.dumps(e2e['launches'])}, FALKON-BLESS path {json.dumps(fb['launches'])}")
    log(f"parity at ragged shapes, worst fp32 max_abs_err: {json.dumps(parity_worst)}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
