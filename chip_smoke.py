#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's FALKON, FALKON-BLESS, k-fold CV, classifier,
KRR serving, streaming and online paths and its Jamba serving path on one H100.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without one

Phases (each a plain function, so a CPU test can rehearse them at a tiny size):

  1. probe      card name, capability (must be (9, 0)), nvidia-smi name and
                power limit, CUDA version; TF32 off for matmuls and cuDNN.
  2. build      compile the nine CUDA kernels from the sources in this checkout.
  3. parity     each kernel against its plain PyTorch version on the card, at
                ragged shapes, all five kernel families, plus bf16 on the
                gaussian family: K1 gram, K2 falkon_matvec, K3 knm_t, K4
                knm_matvec at n = 70 001, M = 1 000, d = 18 (k vector and 3);
                K7 falkon_matvec_masked there with a vector and an (n,) mask,
                k = 3 and k = 40 with 0/1 panels, fractional weights and an
                (n,) mask broadcast to the panel; an all-zeros mask must give
                exactly 0 and an all-ones mask K2's result bit for bit; K2
                with a vector also at M = 10 000 (the cluster route on an
                8-block cluster) and M = 12 289 (just above its cap at
                d = 18: the two-stage route), K2 and K7 with k = 5 panels
                there (the two-stage route); K5 rls_score at R = 70 001,
                M in {1, 1000, 1024}; K6 quadform at n = 70 001,
                m in {1 000, 4 097}.
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
                ladder level above 1 024 centers, if there is one, and K7 at
                the sweep's shape (10^6 rows, the BLESS M, phase 7's 5-fold
                mask); K2's and K7's lines name the route matvec_plan chose,
                K3's the route of knm_t_plan, K4's that of knm_matvec_plan and
                K1's that of gram_plan. Timed and logged beside the record: K3
                at the sweep's shape (10^6 rows, the BLESS M, its 5-column
                right-hand side), K4 at the sweep's panel predict (10^6 rows,
                the BLESS M, 5 columns) and K1 at the predictive variance's
                slab (the rows of QUADFORM_SLAB_BYTES against M = 10^4), and
                phase 12's shapes: K1 on one streamed tile (65 536 training
                rows against the BLESS centers) and K4 on a serving wave of
                4 096 and of 2 048 test rows against M = 10^4.
                Logged beside them, not gated:
                K5 against K1 + K6 at M = 1 024 (the MAX_FUSED_M crossover)
                on K5's rows, and K2 on the two-stage route at M = 16 384
                (above the cluster route's cap; its first stage is K4's and
                its second K3's register route).
  7. cv         exact k-fold CV through the front door on the same data and
                phase 5's BLESS center set: KFoldSweep(folds=5, lams=(1e-5,
                1e-6, 1e-7), iters=20), counts reset just before the sweep and
                read just after. Per-fold scores, best lam, the sweep's time
                beside one naive per-fold refit's (and the naive grid's
                estimate, folds x lams x that time; printed, not gated). Gates:
                a second run repeats fold ids and scores bit for bit; on the
                first 65 536 rows with UniformSampler(m=2048) centers at lam =
                1e-3, each fold's score of a 4-fold sweep agrees within 1e-4
                relative with a naive CudaBackend refit on that fold's
                training rows, both solves converged (residual reductions
                printed); the mask tax, K7 / K2 at the sweep's shape (k = 5),
                at most 1.15 (tools/check_mask_tax.py's bound), timed in turns.
  8. classifier FalkonClassifier(FitConfig(lam=1e-6, iters=20)) on the same
                data and center set, counts reset just before the fit and read
                after the test predictions. Gates: test accuracy within 1e-3
                of 1 - phase 5's FALKON-BLESS test error (same centers, lam and
                iterations), and the two margin columns negatives of each
                other to 1e-5 of max|margin| (CG is homogeneous in b).

 12. krr-online run right after phase 8 on phase 4's data and uniform model
                and phase 5's BLESS centers, weights and fit (the LM phases
                free that memory); counts reset before the phase's work and
                read after. (a) KrrServer: 4 096 requests of 1-64 test rows
                (sizes from --seed), max_wave 4 096, min_bucket 64: every
                request's rows equal model.predict's to 1e-4 * max|pred| (K4);
                requests/s, rows/s, waves, padded rows, buckets. (b)
                AsyncKrrServer(ServeConfig(max_inflight=2)) on the same
                traffic: equal to (a) to 1e-4 * max|pred|; under one
                gram.nan_tile firing every request DONE with one wave failure
                and a split; the backend.error isolation script of
                tests/test_chaos.py replayed here gives the statuses and stats
                of its CPU run (BACKEND_ERROR_EXPECTED). (c) falkon_fit on
                ChunkStore(x, y) in pinned host memory, chunk 65 536, through
                "stream:cuda" (K1 tiles): predictions within 1e-3 * max|pred|
                of phase 5's fit on the device-resident data, allocator peak
                above the resident base < 0.25 * 4 n M. (d)
                resumable_streamed_fit on the same store, a barrier every 4
                chunks: uninterrupted, then killed by ckpt.torn_write at
                pre_rename on its third barrier and resumed; the resumed alpha
                equal bit for bit, test error < 0.2. (e) OnlineFalkon on the
                first 9 * 10^5 rows, 10 appends of 10^4 rows with a warm
                refit after each: within 1e-2 relative of (d); a NaN row
                armed with online.corrupt_row is rejected with the store, H
                and b untouched. Referee of (c)-(e): an fp64 TorchBackend fit
                on fp64 copies of the same rows, centers, weights, lam and
                iterations; the streamed predictions no farther from it than
                phase 5's K2 fit is, plus 1e-3 of max|fp64 pred|, the durable
                and online ones (fp64 accumulators) within 1e-4 of it. Runs
                before phases 9-11 in main().

  9. lm parity  K8 flash_attention and K9 ssd against their plain versions on
                the card, fp32 and bf16: K8 causal and bidirectional, GQA
                groups 1, 4 and 8, S in {1, 1 000, 2 053}, D in {17, 32, 80,
                128} (D = 17 and S = 1 run the tensor-core kernel's padding),
                and Jamba's layer (B = 4, Hq = 32, Hkv = 8, S = 2 048,
                D = 128); K9 at S not a multiple of the chunk, at S = 4 100
                (the state carried over 65 chunks, H = 12 not a multiple of
                the 8-head scan group) and Jamba's layer (B = 4, S = 2 048,
                H = 128, P = 64, N = 16), y and the final state.
 10. decode     jamba-v0.1-52b at full width cut to 8 layers (one period
                group: the 32 layers' 104 GB in bf16 exceed the card), fp32,
                capacity_factor 16 (no drops), random weights from --seed:
                prefill_logits on one 128-token prompt (K8 + K9) against 128
                decode_step calls (no kernel) on the same tokens; counts reset
                before each and read after.
 11. serve      the same model in bf16 at the config's capacity_factor:
                prefill_logits on 4 prompts of 2 048 tokens timed warm
                (prefill tokens/s), then ServeEngine(max_len=256,
                batch_slots=4): three 32-token requests start, a fourth joins
                after 8 steps, 32 decode steps (decode tokens/s, each slot's
                tokens); counts reset before the prefill and read after the
                serving. Then K8 and K9 at the shapes the prefill gives them
                (taken from the config) in the model's dtype: parity, and
                times beside the bound, the plain version and (K8)
                scaled_dot_product_attention; K9 also at the wrapper's
                default chunk (128) beside the model's (64), each beside the
                one-pass bound and its design's bound (the chunk states it
                writes and reads, the second read of x, B and dt).

Tolerances: Gram 2e-5 absolute; K_nM contractions (K7 too) and the
quadratic form 1e-4 * max|ref|; RLS scores 5e-4 relative + 5e-5 (tests/test_backend.py's
form); bf16 3e-2 * max|ref|; end-to-end predictions and variances 1e-3 *
max (beyond the fp32 TorchBackend's own distance from the fp64 referee);
K8 2e-5 (bf16 2e-2) and K9 2e-4 (bf16 3e-2) * max|ref| (tests/test_kernels.py),
and K8 also per query row: max|out_row - ref_row| <= the same factor *
max|ref_row| (a causal row over many keys has outputs far below row 0's);
decode against forward 5e-3 * max|logit| (tests/test_models.py).
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
#: NVIDIA H100 SXM data-sheet peaks (dense, non-tensor fp32; dense bf16 on
#: the tensor cores; HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: kernel name -> (CUDA source, the TPU kernel it replaces).
KERNELS = {
    "gram": ("src/repro_torch/kernels/gram/gram.cu",
             "src/repro/kernels/gram/gram.py:45"),
    "falkon_matvec": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                      "src/repro/kernels/falkon_matvec/falkon_matvec.py:93"),
    "falkon_matvec_masked": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                             "src/repro/kernels/falkon_matvec/falkon_matvec.py:139"),
    "knm_t": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
              "src/repro/kernels/falkon_matvec/falkon_matvec.py:184"),
    "knm_matvec": ("src/repro_torch/kernels/falkon_matvec/falkon_matvec.cu",
                   "src/repro/kernels/falkon_matvec/falkon_matvec.py:221"),
    "rls_score": ("src/repro_torch/kernels/rls_score/rls_score.cu",
                  "src/repro/kernels/rls_score/rls_score.py:65"),
    "quadform": ("src/repro_torch/kernels/quadform/quadform.cu",
                 "src/repro/kernels/quadform/quadform.py:51"),
}
#: the LM kernels (phases 9-11), as KERNELS (which holds the FALKON paths' seven).
LM_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/flash_attention/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:67"),
    "ssd": ("src/repro_torch/kernels/ssd/ssd.cu", "src/repro/kernels/ssd/ssd.py:81"),
}
#: the reference tests' tolerances (tests/test_kernels.py), scaled to max|ref|.
ATTN_TOL, ATTN_BF16_TOL = 2e-5, 2e-2
SSD_TOL, SSD_BF16_TOL = 2e-4, 3e-2
#: decode against forward (tests/test_models.py's tolerance), scaled to max|logit|.
DECODE_TOL = 5e-3
#: the one configuration of the repo that runs both LM kernels.
LM_ARCH = "jamba-v0.1-52b"
#: the kernels each main path must launch (K6 also on the BLESS path when a
#: ladder level holds more than 1 024 distinct centers).
UNIFORM_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec", "quadform")
BLESS_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec", "rls_score")
CV_PATH = ("gram", "falkon_matvec_masked", "knm_t", "knm_matvec")
CLASSIFIER_PATH = ("gram", "falkon_matvec", "knm_t", "knm_matvec")
#: K7 / K2 at the same shape, both timed in the same run (tools/check_mask_tax.py).
MASK_TAX_BOUND = 1.15
CV_RTOL = 1e-4


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


def _row_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (the last axis) of max|out_row - ref_row| / max|ref_row|:
    K8's error scaled per query row, so that rows whose output is small (a
    causal row over many keys) are held as tightly as row 0, which sets
    max|ref|."""
    if out.numel() == 0:
        return 0.0
    if not bool(torch.all(torch.isfinite(out))):
        return math.inf
    err = (out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
    return float(err.max())


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
                  quad_ms=(1_000, 4_097), route_ms=(10_000, 12_289)) -> dict:
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
    # K7's operands: k = 40 spans several column chunks on either route
    v40 = torch.randn((m, 40), generator=g, device=device)
    m_vec = (torch.rand((n,), generator=g, device=device) > 0.3).float()
    m3 = (torch.rand((n, k), generator=g, device=device) > 0.3).float()
    m40 = (torch.rand((n, 40), generator=g, device=device) > 0.3).float()
    m_frac = torch.rand((n, k), generator=g, device=device)
    masked_cases = (("vec", vp[:, 0], m_vec), (f"k={k}", vp, m3), ("k=40", v40, m40),
                    (f"k={k}/fractional", vp, m_frac), (f"k={k}/broadcast", vp, m_vec))
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
            for shape, v, mask in masked_cases:
                check("falkon_matvec_masked", kind, bf16, shape,
                      fo.falkon_matvec(x, z, v, sigma, mask=mask, **kw),
                      fo.falkon_matvec_masked_reference(x, z, v, mask, sigma, **kw))
            for shape, v, mask in masked_cases[:3]:
                tag = f"falkon_matvec_masked/{kind}{'/bf16' if bf16 else ''}/{shape}"
                ones = fo.falkon_matvec(x, z, v, sigma, mask=torch.ones_like(mask), **kw)
                zeros = fo.falkon_matvec(x, z, v, sigma, mask=torch.zeros_like(mask), **kw)
                same = torch.equal(ones, fo.falkon_matvec(x, z, v, sigma, **kw))
                nonzero = int(torch.count_nonzero(zeros))
                log(f"parity {tag}: all-ones mask bit-identical to K2 {same}, all-zeros mask "
                    f"nonzero outputs {nonzero}")
                if not same:
                    bad.append(f"{tag}: an all-ones mask is not bit-identical to K2")
                if nonzero:
                    bad.append(f"{tag}: an all-zeros mask gave {nonzero} nonzero outputs")
            sync(device)

    # K2 and K7 on both routes beyond the shapes above (which take one-block
    # clusters): a vector at M = 10 000 splits over an 8-block cluster; at
    # M = 12 289, just above the cluster route's cap at d = 18, and with k = 5
    # panels at both M, the calls take the two-stage route.
    for mm in route_ms:
        z2 = torch.randn((mm, d), generator=g, device=device)
        v2 = torch.randn((mm, 5), generator=g, device=device)
        mask2 = (torch.rand((n, 5), generator=g, device=device) > 0.3).float()
        for kind in FAMILIES:
            for bf16 in ([False, True] if kind == "gaussian" else [False]):
                kw = dict(kind=kind, bf16=bf16)
                for shape, v, mask in (("vec", v2[:, 0], None), ("k=5", v2, mask2)):
                    plan = fo.matvec_plan(n, mm, d, 1 if v.ndim == 1 else v.shape[1])
                    tag = f"{n}x{mm}/{shape}/{plan.route}/cluster={plan.cluster}"
                    check("falkon_matvec", kind, bf16, tag,
                          fo.falkon_matvec(x, z2, v, sigma, **kw),
                          fo.falkon_matvec_reference(x, z2, v, sigma, **kw))
                    if mask is not None:
                        check("falkon_matvec_masked", kind, bf16, tag,
                              fo.falkon_matvec(x, z2, v, sigma, mask=mask, **kw),
                              fo.falkon_matvec_masked_reference(x, z2, v, mask, sigma, **kw))
                sync(device)
        del z2, v2, mask2

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
                      "k6_ladder": largest(above), "center_set": est.center_set_,
                      "z": est.centers_, "a_diag": est.a_diag_, "alpha": est.model_.alpha}
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
    two). K7 (``falkon_matvec_masked``) is K2 plus the (n, k) mask read and
    its n k multiplies. K5 (``rls_score``, n candidates against m centers) reads x, z, W,
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
    elif name == "falkon_matvec_masked":
        nbytes = 4 * (n * d + m * d + 2 * m * k + n * k)
        ops = gram_ops + 4 * n * m * k + n * k
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
    given G, rowsum((G W) * G); for K7, per row block, G^T ((G V) * mask)."""
    def g(xb):
        return torch.exp(-torch.cdist(xb, z).square() * s)
    if name == "gram":
        return g(x)
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
        if name == "knm_t":
            out += gb.T @ v[i:i + block]
        elif name == "falkon_matvec_masked":
            out += gb.T @ ((gb @ v) * mask[i:i + block])
        else:
            out += gb.T @ (gb @ v)
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


def sweep_mask(n: int, folds: int, seed: int, device) -> torch.Tensor:
    """The (n, folds) training-row mask ``KFoldSweep(folds=folds, seed=seed)``
    solves with: its fold ids, from the fold generator of the seed."""
    from repro_torch.api.sweep import fold_ids, split_generators

    fid = fold_ids(split_generators(seed)[1], n, folds).to(device)
    return (fid[:, None] != torch.arange(folds, device=device)[None, :]).float()


def main_path_calls(t: dict, sigma: float, bless_t: dict, *, folds: int = 5, seed: int = 0):
    """(name, n, m, d, k, kernel call, plain call, library call) for each kernel
    at the shapes the main paths gave it: K1 builds K_MM, K2 and K3 run on
    the training rows with a vector, K4 predicts the test rows, K5 scores the
    largest ladder level with at most 1 024 centers, K6 contracts the test
    rows' Gram block against W at M = 10^4 (the predictive variance), K7 runs
    on the training rows, the BLESS centers and the sweep's (n, folds) mask
    with an (M, folds) panel; "knm_t@cv" is K3 on the training rows, the
    BLESS centers and the sweep's (n, folds) right-hand sides, "knm_matvec@cv"
    K4 on the same rows and centers with an (M, folds) panel (the sweep's
    panel predict), "gram@slab" K1 on the test rows of one predictive-variance
    slab (``QUADFORM_SLAB_BYTES``) against the M = 10^4 centers, "gram@stream"
    K1 on one of phase 12's streamed chunks (``KRR_CHUNK`` training rows
    against the BLESS centers), "knm_matvec@wave" and "knm_matvec@wave_half"
    K4 on phase 12's serving waves (``KRR_MAX_WAVE`` and half as many test
    rows against the M = 10^4 centers), and "quadform@ladder" K6 at the largest ladder level above 1 024 centers
    (timed and logged, not part of the kernels record)."""
    from repro_torch.core import CudaBackend, make_kernel
    from repro_torch.core.backend import QUADFORM_SLAB_BYTES
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
    zb = bless_t["z"]
    mask = sweep_mask(n, folds, seed, x.device)
    vb = torch.randn((zb.shape[0], folds), generator=torch.Generator(device=x.device)
                     .manual_seed(seed), device=x.device)
    y_cv = y[:, None] * mask  # the sweep's right-hand sides: one column per fold
    slab = xte[:max(1, QUADFORM_SLAB_BYTES // (4 * m))]  # CudaBackend's variance slab
    tile = x[:KRR_CHUNK]  # one streamed / accumulated chunk of phase 12
    waves = [("knm_matvec@wave", xte[:KRR_MAX_WAVE]),
             ("knm_matvec@wave_half", xte[:KRR_MAX_WAVE // 2])]  # phase 12's buckets
    extra = [("knm_t@cv", n, zb.shape[0], d, folds, lambda: fo.knm_t(x, zb, y_cv, sigma),
              lambda: fo.knm_t_reference(x, zb, y_cv, sigma),
              lambda: _library_call("knm_t", x, zb, y_cv, s)),
             ("knm_matvec@cv", n, zb.shape[0], d, folds, lambda: fo.knm_matvec(x, zb, vb, sigma),
              lambda: fo.knm_matvec_reference(x, zb, vb, sigma),
              lambda: _library_call("knm_matvec", x, zb, vb, s)),
             ("gram@slab", slab.shape[0], m, d, m, lambda: go.gram(slab, z, sigma),
              lambda: go.gram_reference(slab, z, sigma),
              lambda: _library_call("gram", slab, z, None, s)),
             ("gram@stream", tile.shape[0], zb.shape[0], d, zb.shape[0],
              lambda: go.gram(tile, zb, sigma), lambda: go.gram_reference(tile, zb, sigma),
              lambda: _library_call("gram", tile, zb, None, s))]
    extra += [(name, xw.shape[0], m, d, 1, lambda xw=xw: fo.knm_matvec(xw, z, v, sigma),
               lambda xw=xw: fo.knm_matvec_reference(xw, z, v, sigma),
               lambda xw=xw: _library_call("knm_matvec", xw, z, v, s)) for name, xw in waves]
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
        ("falkon_matvec_masked", n, zb.shape[0], d, folds,
         lambda: fo.falkon_matvec(x, zb, vb, sigma, mask=mask),
         lambda: fo.falkon_matvec_masked_reference(x, zb, vb, mask, sigma),
         lambda: _library_call("falkon_matvec_masked", x, zb, vb, s, mask=mask)),
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
            tol = GRAM_TOL if name.startswith("gram") else KNM_TOL * scale
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
    """CUDA-event times of each kernel, its plain version and the yardstick;
    K2's and K7's rows name the route ``matvec_plan`` gave them, K3's that of
    ``knm_t_plan``, K4's that of ``knm_matvec_plan`` and K1's that of
    ``gram_plan``."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go

    times = {}
    for name, n, m, d, k, kern, plain, library in calls:
        b_ms, b_by = bound(name.split("@")[0], n, m, d, k)
        times[name] = {"ms": _cuda_ms(kern, repeats), "plain_ms": _cuda_ms(plain, plain_repeats),
                       "library_ms": _cuda_ms(library, plain_repeats),
                       "bound_ms": b_ms, "bound_by": b_by, "shape": [n, m, d, k]}
        if name.startswith("quadform"):
            times[name]["design"] = "register-tiled fp32"
        elif name == "rls_score":
            times[name]["design"] = ("on-chip Gram slab for two W column tiles, G W in 8x4 "
                                     "register tiles, depth split over two warp groups")
        elif name.startswith("gram"):
            plan = go.gram_plan(n, m, d)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"{plan.rows}-row stripes walking runs of {plan.run} {plan.cols}-column tiles, "
                + ("16-byte" if plan.route == "wide" else "4-byte") + " streaming stores"
                if plan.route != "tiled" else "shared 64x64 gram_tile")
        elif name.startswith("knm_matvec"):
            plan = fo.knm_matvec_plan(n, m, d, k)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"K3's register kernel on (z, x): G in registers, {plan.slice_rows}-row slices, "
                f"{plan.n_chunks} center chunks"
                if plan.route == "register" else "shared 64x64 gram_tile")
        elif name.startswith("knm_t"):
            plan = fo.knm_t_plan(n, m, d, k)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"G in registers, {plan.slice_cols}-center slices, {plan.n_chunks} row chunks"
                if plan.route == "register" else "shared 64x64 gram_tile")
        elif name.startswith("falkon_matvec"):
            plan = fo.matvec_plan(n, m, d, k)
            times[name]["route"] = plan.route
            times[name]["design"] = (
                f"one Gram build per call, {plan.cluster}-block cluster, T through DSMEM"
                if plan.route == "cluster" else "two Gram builds per call (K4 then K3)")
        log(f"times {name}: {json.dumps(times[name])}")
    return times


def crossovers(device, times: dict, *, sigma: float = 4.0, seed: int = 0, d: int = 18,
               above_cap: tuple[int, int] = (1_000_000, 16_384)) -> dict:
    """Two times beside phase 6's, logged and not gated: K5 against K1 + K6 at
    M = MAX_FUSED_M on K5's main-path rows (where CudaBackend switches from
    the one to the other), and K2 on the two-stage route at an M above the
    cluster route's cap (its first stage K4 by ``knm_matvec_plan``, its
    second K3 by ``knm_t_plan``)."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go
    from repro_torch.kernels import quadform_ops as qo
    from repro_torch.kernels import rls_score_ops as ro

    r = times["rls_score"]["shape"][0]
    mm = ro.MAX_FUSED_M
    x, z, w, mask, lamn = score_inputs(device, r, mm, d, "gaussian", sigma, seed + 1)
    out = {"k5_vs_k1_k6": {"shape": [r, mm, d],
                           "k5_ms": _cuda_ms(lambda: ro.rls_score(x, z, w, mask, lamn, sigma), 5),
                           "k1_k6_ms": _cuda_ms(lambda: qo.quadform(
                               go.gram(x, z, sigma) * mask[None, :], w), 5)}}
    del x, z, w, mask
    n, m = above_cap
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    z = torch.randn((m, d), generator=g, device=device)
    v = torch.randn((m,), generator=g, device=device)
    plan = fo.matvec_plan(n, m, d, 1)
    b_ms, b_by = bound("falkon_matvec", n, m, d, 1)
    stage1 = fo.knm_matvec_plan(n, m, d, 1)
    out["falkon_matvec_above_cap"] = {"shape": [n, m, d, 1], "route": plan.route,
                                      "stage1_route": stage1.route,
                                      "stage1_center_chunks": stage1.n_chunks,
                                      "stage2_route": fo.knm_t_plan(n, m, d, 1).route,
                                      "ms": _cuda_ms(lambda: fo.falkon_matvec(x, z, v, sigma), 2),
                                      "bound_ms": b_ms, "bound_by": b_by}
    del x, z, v
    for key, row in out.items():
        log(f"times {key}: {json.dumps(row)}")
    return out


# ---------------------------------------------------------------------------
# 7. exact k-fold CV
# ---------------------------------------------------------------------------


def cross_validation(device, t: dict, center_set, *, folds: int = 5,
                     lams=(1e-5, 1e-6, 1e-7), iters: int = 20, sigma: float = 4.0,
                     seed: int = 0, exact_rows: int = 65_536, exact_m: int = 2_048) -> dict:
    """KFoldSweep through the front door on phase 4's data and the given
    (phase 5's) center set, with the launch counts reset just before the
    sweep and read just after; then the repeat gate, one naive refit's time,
    the exactness gate on the first ``exact_rows`` rows and the mask tax."""
    from repro_torch import kernels
    from repro_torch.api import KFoldSweep, UniformSampler
    from repro_torch.core import CudaBackend, falkon_fit, make_kernel
    from repro_torch.kernels import falkon_matvec_ops as fo

    xtr, ytr = t["x"], t["y"]
    n = xtr.shape[0]
    on_card = torch.device(device).type == "cuda"
    kern = make_kernel("gaussian", sigma=sigma)
    sweep = KFoldSweep(kernel=kern, lams=lams, folds=folds, iters=iters, seed=seed,
                       device=str(device))
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep.run(xtr, ytr, center_set=center_set)
    sync(device)
    sweep_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    again = sweep.run(xtr, ytr, center_set=center_set)
    repeat_equal = (torch.equal(res.fold_id, again.fold_id)
                    and torch.equal(res.scores, again.scores))
    for li, lam in enumerate(res.lams):
        log(f"cv lam={lam:g}: fold scores {json.dumps(res.scores[li].tolist())}, "
            f"mean {float(res.mean_scores[li]):.6f}")

    # one naive refit at full n: fold 0's training rows, the first lam
    m = int(center_set.count)
    dev = xtr.device
    z, a_diag = xtr[center_set.idx[:m].to(dev)], center_set.weight[:m].to(dev)
    train = res.fold_id != 0
    xf, yf = xtr[train], ytr[train]
    sync(device)
    t0 = time.perf_counter()
    falkon_fit(kern, xf, yf, z, lams[0], a_diag=a_diag, iters=iters, backend=CudaBackend())
    sync(device)
    naive_s = time.perf_counter() - t0
    del xf, yf

    # 60 iterations: both solves reach a squared-residual reduction near fp32
    # noise (on the CPU at this size 20 and 40 iterations agree to 1.1e-6 alike)
    exact = exact_cv(device, xtr[:exact_rows], ytr[:exact_rows], kern,
                     UniformSampler(m=exact_m).sample(seed, xtr[:exact_rows], kern),
                     lam=1e-3, folds=4, iters=60, seed=seed)

    # the mask tax: K7 against K2 at the sweep's shape, timed in turns
    tax = None
    if on_card:
        mask = sweep_mask(n, folds, seed, dev)
        v = torch.randn((m, folds), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        k2, k7 = [], []
        for fn, into in ((lambda: fo.falkon_matvec(xtr, z, v, sigma), k2),
                         (lambda: fo.falkon_matvec(xtr, z, v, sigma, mask=mask), k7),
                         (lambda: fo.falkon_matvec(xtr, z, v, sigma, mask=mask), k7),
                         (lambda: fo.falkon_matvec(xtr, z, v, sigma), k2)):
            into.append(_cuda_ms(fn, 3))
        tax = {"k2_ms": k2, "k7_ms": k7, "ratio": sum(k7) / sum(k2), "shape": [n, m, folds]}
        log(f"mask tax (K7 / K2, turns K2 K7 K7 K2): {json.dumps(tax)}")

    out = {"n": n, "m": m, "folds": folds, "lams": list(res.lams), "iters": iters,
           "scores": res.scores.tolist(), "best_lam": res.best_lam, "sweep_s": sweep_s,
           "naive_refit_s": naive_s, "naive_grid_estimate_s": folds * len(lams) * naive_s,
           "launches": launches, "repeat_bit_identical": repeat_equal, "exact": exact,
           "mask_tax": tax}
    log(f"cv: {json.dumps({k: v for k, v in out.items() if k != 'scores'})}")
    bad = []
    if not bool(torch.all(torch.isfinite(res.scores))) or res.scores.shape != (len(lams), folds):
        bad.append(f"scores: shape {tuple(res.scores.shape)}, finite "
                   f"{bool(torch.all(torch.isfinite(res.scores)))}")
    if not repeat_equal:
        bad.append("a second sweep with the same seed gave other fold ids or scores")
    if not exact["max_rel_err"] <= CV_RTOL:
        bad.append(f"fold scores differ from naive refits by {exact['max_rel_err']:.3e} relative "
                   f"> {CV_RTOL}")
    if on_card:
        missing = [name for name in CV_PATH if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the CV path: {missing}")
        if not tax["ratio"] <= MASK_TAX_BOUND:
            bad.append(f"mask tax K7 / K2 = {tax['ratio']:.3f} > {MASK_TAX_BOUND}")
    if bad:
        raise PhaseError("cv failed: " + "; ".join(bad))
    return out


def exact_cv(device, x, y, kern, center_set, *, lam: float, folds: int, iters: int,
             seed: int) -> dict:
    """A ``folds``-fold sweep at one lam against a naive CudaBackend refit on
    each fold's training rows, same centers: max relative score difference.
    The sweep's solve is run once more as ``falkon_fit(row_mask=)`` to read its
    residual reduction (and to check that it gives the sweep's scores)."""
    from repro_torch.api import KFoldSweep
    from repro_torch.core import CudaBackend, falkon_fit

    res = KFoldSweep(kernel=kern, lams=(lam,), folds=folds, iters=iters, seed=seed,
                     device=str(device)).run(x, y, center_set=center_set)
    m = int(center_set.count)
    z = x[center_set.idx[:m].to(x.device)]
    a_diag = center_set.weight[:m].to(x.device)
    held = res.fold_id[:, None] == torch.arange(folds, device=x.device)[None, :]
    train = (~held).float()
    panel = falkon_fit(kern, x, y[:, None] * train, z, lam, a_diag=a_diag, iters=iters,
                       backend=CudaBackend(), row_mask=train)
    sq = (panel.predict(x) - y[:, None]) ** 2
    replay = torch.sum(sq * held, dim=0) / torch.sum(held, dim=0)
    naive, naive_red = [], []
    for f in range(folds):
        rows = ~held[:, f]
        model = falkon_fit(kern, x[rows], y[rows], z, lam, a_diag=a_diag, iters=iters,
                           backend=CudaBackend())
        naive.append(float(torch.mean((model.predict(x[~rows]) - y[~rows]) ** 2)))
        naive_red.append(float(model.diagnostics.reduction.max()))
    scores = res.scores[0].tolist()
    rel = [abs(a - b) / abs(b) for a, b in zip(scores, naive)]
    out = {"rows": x.shape[0], "m": m, "lam": lam, "folds": folds, "iters": iters,
           "sweep_scores": scores, "naive_scores": naive, "max_rel_err": max(rel),
           "sweep_residual_reduction": panel.diagnostics.reduction.tolist(),
           "naive_residual_reduction": naive_red,
           "replay_equals_sweep": bool(torch.equal(replay, res.scores[0]))}
    log(f"cv exactness: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# 8. the classifier
# ---------------------------------------------------------------------------


def classify(device, t: dict, center_set, bless_test_error: float, *, lam: float = 1e-6,
             iters: int = 20, sigma: float = 4.0, seed: int = 0) -> dict:
    """FalkonClassifier through the front door on phase 4's data and the given
    center set, counts reset just before the fit and read after the test
    predictions; its accuracy against 1 - the FALKON-BLESS regressor's test
    error on the same centers, lam and iterations."""
    from repro_torch import kernels
    from repro_torch.api import FalkonClassifier, FitConfig

    xtr, ytr, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    clf = FalkonClassifier(kernel="gaussian", sigma=sigma,
                           config=FitConfig(lam=lam, iters=iters, seed=seed, device=str(device)))
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clf.fit(xtr, ytr, center_set=center_set)
    sync(device)
    fit_s = time.perf_counter() - t0
    margins = clf.decision_function(xte)
    accuracy = clf.score(xte, yte)
    sync(device)
    launches = kernels.launch_counts()
    scale = float(margins.abs().max())
    antisym = float((margins[:, 0] + margins[:, 1]).abs().max()) / scale
    res = {"n_train": xtr.shape[0], "classes": clf.classes_.tolist(),
           "m": int(center_set.count), "lam": lam, "iters": iters, "fit_s": fit_s,
           "accuracy": accuracy, "one_minus_bless_error": 1.0 - bless_test_error,
           "margin_sum_over_max": antisym,
           "cg_residual_reduction": clf.model_.diagnostics.reduction.tolist(),
           "launches": launches}
    log(f"classifier: {json.dumps(res)}")
    bad = []
    if tuple(margins.shape) != (xte.shape[0], 2) or not math.isfinite(scale):
        bad.append(f"margins: shape {tuple(margins.shape)}, max|margin| {scale}")
    if not abs(accuracy - (1.0 - bless_test_error)) <= E2E_TOL:
        bad.append(f"accuracy {accuracy:.5f} is not within {E2E_TOL} of 1 - the FALKON-BLESS "
                   f"test error ({1.0 - bless_test_error:.5f})")
    if not antisym <= 1e-5:
        bad.append(f"the two margin columns are not negatives of each other: {antisym:.3e}")
    if torch.device(device).type == "cuda":
        missing = [name for name in CLASSIFIER_PATH if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the classifier path: {missing}")
    if bad:
        raise PhaseError("classifier failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# 12. KRR serving, out-of-core streaming, durable and online FALKON
# ---------------------------------------------------------------------------

#: the kernels phase 12 must launch: K4 in every serving wave, K1 in every
#: streamed tile, accumulator chunk and K_MM.
KRR_ONLINE_PATH = ("gram", "knm_matvec")
#: phase 12's streamed chunk (rows) and largest serving wave (rows); phase 6
#: times K1 and K4 at these shapes.
KRR_CHUNK = 65_536
KRR_MAX_WAVE = 4096
#: the durable and online fits' distance from the fp64 referee, over max
#: |fp64 pred|: fp64 accumulators of K1's fp32 G read 9.1e-6 and 8.2e-6 at
#: SUSY scale on the H100, against 4.1e-3 for the fp32 K2 fit.
FP64_ACC_TOL = 1e-4
#: (statuses, stats) of the backend.error isolation script below, the
#: reference's ``test_dispatch_error_wave_isolated`` (tests/test_chaos.py):
#: two 8-row requests in one 16-row wave; the wave's dispatch raises once,
#: each half is retried alone and served.
BACKEND_ERROR_EXPECTED = (
    ["done", "done"],
    {"requests": 2, "rows": 16, "dispatches": 3, "padded_rows": 16, "buckets": [16],
     "wave_failures": 1, "splits": 1, "shed": 0, "expired": 0, "failed": 0,
     "degraded_waves": 0, "swaps": 0, "swaps_rejected": 0, "model_version": 0,
     "last_swap": None})


def backend_error_script(server_cls, config_cls, faults, model, requests):
    """The isolation script: ``requests`` (host arrays) submitted to a fresh
    ``server_cls(model, config=config_cls(min_bucket=16))``, served with
    ``backend.error`` armed for one firing. Returns (statuses, stats with
    the bucket set as a sorted list). The classes and the ``faults`` module
    are arguments, so the same script runs on either package."""
    srv = server_cls(model, config=config_cls(min_bucket=16))
    rids = [srv.submit(q) for q in requests]
    with faults.fault("backend.error", times=1):
        srv.run_until_idle()
    stats = dict(srv.stats)
    stats["buckets"] = sorted(stats["buckets"])
    return [srv.status(r).value for r in rids], stats


def serving_traffic(xte_host: torch.Tensor, requests: int, max_rows: int,
                    seed: int) -> list[torch.Tensor]:
    """``requests`` host requests of 1..``max_rows`` rows (sizes from
    ``seed``), consecutive slices of the test set, wrapping around."""
    g = torch.Generator().manual_seed(seed)
    sizes = torch.randint(1, max_rows + 1, (requests,), generator=g).tolist()
    out, off = [], 0
    for r in sizes:
        if off + r > xte_host.shape[0]:
            off = 0
        out.append(xte_host[off:off + r])
        off += r
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b| (inf when a is not finite)."""
    if not bool(torch.all(torch.isfinite(a))):
        return math.inf
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def fp64_referee(kern, x, y, z, a_diag, lam: float, iters: int, xte) -> torch.Tensor:
    """Predictions on ``xte`` of a TorchBackend fit on fp64 copies of the same
    rows, centers, weights, lam and iterations: phase 12's referee. The fp32
    fits at this lam lie ~4e-3 of max|pred| from it, while fp64 sums of the
    same fp32 Gram values lie ~1e-5 from it, so the fp32 fits are held to it
    relative to the K2 fit, as phase 4's refits are."""
    from repro_torch.core import TorchBackend, falkon_fit

    be = TorchBackend()
    model = falkon_fit(kern, x.double(), y.double(), z.double(), lam, a_diag=a_diag.double(),
                       iters=iters, backend=be)
    return model.predict(xte.double(), backend=be)


def krr_online(device, t: dict, bless_t: dict, *, sigma: float = 4.0, lam: float = 1e-6,
               iters: int = 20, requests: int = 4096, max_rows: int = 64,
               max_wave: int = KRR_MAX_WAVE, min_bucket: int = 64, chunk: int = KRR_CHUNK,
               ckpt_every: int = 4, online_rows: int = 900_000, appends: int = 10,
               append_rows: int = 10_000, seed: int = 0, max_error: float = 0.2) -> dict:
    """Phase 12 on phase 4's data and model and phase 5's BLESS centers,
    weights and fit, with the launch counts reset just before the phase's
    work and read just after (the direct predictions the gates compare with
    are made before the reset):

      (a) ``KrrServer`` on phase 4's uniform model: ``requests`` requests of
          1..``max_rows`` test rows, one flush; each request's rows against
          ``model.predict`` of the same rows, 1e-4 * max|pred|.
      (b) ``AsyncKrrServer(ServeConfig(max_inflight=2))`` on the same
          traffic: equal to (a) to 1e-4 * max|pred|; then under one
          ``gram.nan_tile`` firing every request DONE with one wave failure
          and a split; then the backend.error isolation script, whose
          statuses and stats must be ``BACKEND_ERROR_EXPECTED``.
      (c) ``falkon_fit`` on ``ChunkStore(x, y, chunk=chunk)`` (pinned host
          memory on the card) through ``"stream:cuda"``: predictions within
          1e-3 * max|pred| of phase 5's fit on the device-resident data
          through ``CudaBackend`` (same centers, weights, lam and
          iterations), and the allocator's peak above what was resident
          before the fit < 0.25 * 4 n M.
      (d) ``resumable_streamed_fit`` on the same store and centers,
          ``ckpt_every`` chunks per barrier: uninterrupted, then killed by
          ``ckpt.torn_write`` at ``pre_rename`` on its third barrier and
          resumed; the resumed alpha equals the uninterrupted one bit for
          bit, and the test error is below ``max_error``.
      (e) ``OnlineFalkon`` on the first ``online_rows`` rows, ``appends``
          appends of ``append_rows`` rows, a warm refit after each: final
          predictions within 1e-2 relative of (d)'s; a NaN row armed with
          ``online.corrupt_row`` is rejected with the store, H and b
          untouched (``torch.equal``) and the caller's batch unwritten.

    The referee of (c)-(e) is ``fp64_referee`` (each distance a max abs
    difference over max |fp64 prediction|): the streamed fit no farther from
    it than phase 5's K2 fit is, plus E2E_TOL; the durable and online fits,
    whose accumulators and solve are fp64, within FP64_ACC_TOL.
    Each step's launches are recorded beside its times.
    """
    import tempfile

    from repro_torch import kernels
    from repro_torch.api import (AsyncKrrServer, ChunkStore, KrrServer, OnlineFalkon,
                                 ServeConfig, resumable_streamed_fit)
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import FalkonModel, falkon_fit, health, make_kernel
    from repro_torch.core.backend import backend_for_device
    from repro_torch.serving import RequestStatus
    from repro_torch.stream import device_memory_stats
    from repro_torch.testing import faults

    on_card = torch.device(device).type == "cuda"
    xtr, ytr, xte, yte = t["x"], t["y"], t["xte"], t["yte"]
    n = xtr.shape[0]
    kern = make_kernel("gaussian", sigma=sigma)
    be = backend_for_device(device)
    model = FalkonModel(centers=t["z"], alpha=t["alpha"], kernel=kern, backend=be)
    zb, ab = bless_t["z"], bless_t["a_diag"]
    m = zb.shape[0]
    bless_model = FalkonModel(centers=zb, alpha=bless_t["alpha"], kernel=kern, backend=be)
    traffic = serving_traffic(xte.cpu(), requests, max_rows, seed)
    direct = model.predict(torch.cat(traffic).to(xte.device))
    direct_parts = torch.split(direct, [q.shape[0] for q in traffic])
    scale = float(direct.abs().max())
    ref_pred = bless_model.predict(xte)
    ref64 = fp64_referee(kern, xtr, ytr, zb, ab, lam, iters, xte)
    scale64 = float(ref64.abs().max())

    def to_referee(pred: torch.Tensor) -> float:
        """max |pred - the fp64 referee's| / max |the referee's| (inf if not finite)."""
        if not bool(torch.all(torch.isfinite(pred))):
            return math.inf
        return float((pred.double() - ref64).abs().max()) / scale64

    res = {"n_train": n, "m_uniform": t["z"].shape[0], "m": m, "requests": requests,
           "rows": int(direct.shape[0]), "chunk": chunk}
    bad = []
    seen = dict.fromkeys(KRR_ONLINE_PATH, 0)

    def step_launches() -> dict:
        """The path's launches since the previous call (counts since the reset)."""
        now = kernels.launch_counts()
        out = {name: now[name] - seen[name] for name in KRR_ONLINE_PATH}
        seen.update({name: now[name] for name in KRR_ONLINE_PATH})
        return out

    sync(device)
    kernels.reset_launch_counts()
    # (a) KrrServer
    srv = KrrServer(model, max_wave=max_wave, min_bucket=min_bucket)
    t0 = time.perf_counter()
    rids = [srv.submit(q) for q in traffic]
    out = srv.flush()
    sync(device)
    serve_s = time.perf_counter() - t0
    err_a = max(float((out[r] - d).abs().max()) for r, d in zip(rids, direct_parts)) / scale
    res["serve"] = {"seconds": serve_s, "requests_per_s": requests / serve_s,
                    "rows_per_s": int(direct.shape[0]) / serve_s,
                    "dispatches": srv.stats["dispatches"], "padded_rows": srv.stats["padded_rows"],
                    "buckets": sorted(srv.stats["buckets"]), "err_over_max": err_a,
                    "launches": step_launches()}
    if not err_a <= KNM_TOL:
        bad.append(f"(a) KrrServer rows {err_a:.3e} of max|pred| from model.predict")

    # (b) AsyncKrrServer: the same traffic, then a NaN tile, then backend.error
    asrv = AsyncKrrServer(model, config=ServeConfig(max_wave=max_wave, min_bucket=min_bucket,
                                                    max_inflight=2))
    t0 = time.perf_counter()
    arids = [asrv.submit(q) for q in traffic]
    asrv.run_until_idle()
    sync(device)
    async_s = time.perf_counter() - t0
    done = all(asrv.status(r) == RequestStatus.DONE for r in arids)
    err_b = (max(float((asrv.result(a) - out[r]).abs().max()) for a, r in zip(arids, rids))
             / scale if done else math.inf)
    nsrv = AsyncKrrServer(model, config=ServeConfig(max_wave=max_wave, min_bucket=min_bucket,
                                                    max_inflight=2))
    nrids = [nsrv.submit(q) for q in traffic]
    with faults.fault("gram.nan_tile", times=1):
        nsrv.run_until_idle()
    nan_done = all(nsrv.status(r) == RequestStatus.DONE for r in nrids)
    g = torch.Generator().manual_seed(seed)
    script = backend_error_script(AsyncKrrServer, ServeConfig, faults, model,
                                  [torch.randn((8, xte.shape[1]), generator=g) for _ in range(2)])
    res["async"] = {"seconds": async_s, "requests_per_s": requests / async_s,
                    "dispatches": asrv.stats["dispatches"], "p99_wave_s": asrv.p99_latency(),
                    "err_over_max": err_b, "nan_tile": {
                        "all_done": nan_done, "wave_failures": nsrv.stats["wave_failures"],
                        "splits": nsrv.stats["splits"]},
                    "backend_error_script": {"statuses": script[0], "stats": script[1]},
                    "launches": step_launches()}
    if not err_b <= KNM_TOL:
        bad.append(f"(b) AsyncKrrServer results {err_b:.3e} of max|pred| from (a)'s")
    if not (nan_done and nsrv.stats["wave_failures"] == 1 and nsrv.stats["splits"] >= 1):
        bad.append(f"(b) nan_tile isolation: {res['async']['nan_tile']}")
    if list(script) != list(BACKEND_ERROR_EXPECTED):
        bad.append(f"(b) backend.error script gave {script}, not {BACKEND_ERROR_EXPECTED}")

    # (c) the streamed fit from pinned host memory
    store = ChunkStore(xtr, ytr, chunk=chunk, device=device)
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = device_memory_stats(device)["allocated_bytes.all.current"]
    t0 = time.perf_counter()
    smodel = falkon_fit(kern, store, ytr, zb, lam, a_diag=ab, iters=iters, backend="stream:cuda")
    sync(device)
    stream_s = time.perf_counter() - t0
    peak = device_memory_stats(device)["allocated_bytes.all.peak"] - base if on_card else None
    launches_c = step_launches()
    spred = smodel.predict(xte)
    err_c = _rel(spred, ref_pred)
    res["referee"] = {"rows": n, "max_abs_pred_fp64": scale64, "k2_fit": to_referee(ref_pred),
                      "stream": to_referee(spred)}
    res["stream"] = {"fit_s": stream_s, "n_chunks": store.n_chunks,
                     "test_error": float(torch.mean((torch.sign(spred) != yte).float())),
                     "err_over_max_vs_cuda_fit": err_c, "peak_bytes_above_base": peak,
                     "knm_bytes": 4 * n * m,
                     "cg_residual_reduction": float(smodel.diagnostics.reduction.max()),
                     "launches": launches_c}
    if not err_c <= E2E_TOL:
        bad.append(f"(c) streamed fit {err_c:.3e} of max|pred| from the CudaBackend fit")
    if peak is not None and not peak < 0.25 * 4 * n * m:
        bad.append(f"(c) allocator peak {peak} B above base is not < 0.25 * 4 n M")

    # (d) the durable fit: uninterrupted, then killed at the third barrier and resumed
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(centers=zb, lam=lam, a_diag=ab, iters=iters, backend="stream:cuda",
                  ckpt_every=ckpt_every, key=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        dmodel = resumable_streamed_fit(kern, store, ckpt_dir=f"{tmp}/whole", **kw)
        sync(device)
        durable_s = time.perf_counter() - t0
        killed = False
        t0 = time.perf_counter()
        with faults.fault("ckpt.torn_write", stage="pre_rename", skip=2, times=1):
            try:
                resumable_streamed_fit(kern, store, ckpt_dir=f"{tmp}/killed", **kw)
            except faults.FaultInjected:
                killed = True
        sync(device)
        killed_s = time.perf_counter() - t0
        resumed_from = latest_step(f"{tmp}/killed")
        t0 = time.perf_counter()
        rmodel = resumable_streamed_fit(kern, store, ckpt_dir=f"{tmp}/killed", **kw)
        sync(device)
        resume_s = time.perf_counter() - t0
    launches_d = step_launches()
    dpred = dmodel.predict(xte)
    bitwise = torch.equal(rmodel.alpha, dmodel.alpha)
    res["durable"] = {"fit_s": durable_s, "killed_s": killed_s, "resume_s": resume_s,
                      "killed": killed, "resumed_from_step": resumed_from,
                      "bit_identical": bitwise,
                      "cg_residual_reduction": float(dmodel.diagnostics.reduction.max()),
                      "test_error": float(torch.mean((torch.sign(dpred) != yte).float())),
                      "err_over_max_vs_cuda_fit": _rel(dpred, ref_pred),
                      "launches": launches_d}
    res["referee"]["durable"] = to_referee(dpred)
    if not (killed and resumed_from == 2 * ckpt_every):
        bad.append(f"(d) the torn write did not kill the fit at its third barrier "
                   f"(killed {killed}, latest step {resumed_from})")
    if not bitwise:
        bad.append("(d) the resumed alpha differs from the uninterrupted alpha")
    if not res["durable"]["test_error"] < max_error:
        bad.append(f"(d) durable test error {res['durable']['test_error']:.4f} >= {max_error}")

    # (e) online: seed batch, appends with warm refits, the NaN fence
    t0 = time.perf_counter()
    online = OnlineFalkon(kern, zb, lam, x=ChunkStore(xtr[:online_rows], ytr[:online_rows],
                                                      chunk=chunk, device=device),
                          a_diag=ab, iters=iters, backend="stream:cuda")
    sync(device)
    seed_s = time.perf_counter() - t0
    refit_ms, append_ms = [], []
    for i in range(appends):
        lo = online_rows + i * append_rows
        t0 = time.perf_counter()
        online.append(xtr[lo:lo + append_rows], ytr[lo:lo + append_rows])
        sync(device)
        append_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        omodel = online.refit()
        sync(device)
        refit_ms.append(1e3 * (time.perf_counter() - t0))
    launches_e = step_launches()
    opred = omodel.predict(xte)
    err_e = _rel(opred, dpred)
    res["referee"]["online"] = to_referee(opred)
    h0, b0, x0, n0 = online._h.clone(), online._b.clone(), online.store.x.clone(), len(online.store)
    batch = xtr[:100].clone()
    rejected = False
    with faults.fault("online.corrupt_row", row=3):
        try:
            online.append(batch, ytr[:100])
        except health.NonFiniteError:
            rejected = True
    untouched = (len(online.store) == n0 and torch.equal(online.store.x, x0)
                 and torch.equal(online._h, h0) and torch.equal(online._b, b0)
                 and torch.equal(batch, xtr[:100]))
    res["online"] = {"seed_rows": online_rows, "seed_s": seed_s, "appends": appends,
                     "append_rows": append_rows, "append_ms": append_ms, "refit_ms": refit_ms,
                     "rows": online.counters["rows"], "err_over_max_vs_durable": err_e,
                     "cg_residual_reduction": float(omodel.diagnostics.reduction.max()),
                     "nan_rejected": rejected, "nan_state_untouched": untouched,
                     "launches": launches_e}
    if not err_e <= 1e-2:
        bad.append(f"(e) online predictions {err_e:.3e} of max|pred| from the durable fit's")
    if not (rejected and untouched):
        bad.append(f"(e) NaN fence: rejected {rejected}, state untouched {untouched}")
    if not res["referee"]["stream"] <= res["referee"]["k2_fit"] + E2E_TOL:
        bad.append(f"(c) the streamed fit is {res['referee']['stream']:.3e} from the fp64 "
                   f"referee, farther than the K2 fit ({res['referee']['k2_fit']:.3e}) + {E2E_TOL}")
    for step in ("durable", "online"):
        if not res["referee"][step] <= FP64_ACC_TOL:
            bad.append(f"the {step} fit is {res['referee'][step]:.3e} from the fp64 referee "
                       f"> {FP64_ACC_TOL}")
    sync(device)
    launches = kernels.launch_counts()
    res["launches"] = launches
    log(f"krr_online: {json.dumps(res)}")
    if on_card:
        missing = [name for name in KRR_ONLINE_PATH if launches[name] == 0]
        if missing:
            bad.append(f"kernels not launched on the serving / streaming path: {missing}")
    if bad:
        raise PhaseError("krr-online failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# 9-11. the LM: K8 and K9 parity, decode against forward, serving
# ---------------------------------------------------------------------------

#: K8 parity cases (B, Hq, Hkv, S, D, causal): GQA groups 1, 4 and 8, ragged S
#: and D (D = 17 and S = 1 pad the tensor-core kernel's shared-memory tiles),
#: and Jamba's attention layer at 4 prompts of 2 048 tokens.
ATTN_CASES = [(1, 8, 8, 1000, 32, True), (1, 8, 2, 2053, 80, True), (1, 8, 1, 1000, 128, False),
              (2, 4, 1, 2053, 32, False), (4, 32, 8, 2048, 128, True), (1, 8, 2, 1000, 17, True),
              (2, 8, 8, 1, 128, True)]
#: K9 parity cases (B, S, H, P, N, chunk): S not a multiple of the chunk, a
#: state carried over 65 chunks with H not a multiple of the 8-head scan
#: group, and Jamba's Mamba layer at 4 prompts of 2 048 tokens with the
#: model's chunk.
SSD_CASES = [(1, 1000, 3, 64, 16, 64), (2, 2053, 4, 32, 8, 128), (1, 4100, 12, 64, 16, 64),
             (4, 2048, 128, 64, 16, 64)]


def lm_config(*, n_layers: int = 8, **overrides):
    """Jamba v0.1 at full width, cut to ``n_layers`` (one period group of 8:
    the 32 layers' 52 B parameters, 104 GB in bf16, exceed the card)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers, **overrides)


def attention_inputs(device, b, hq, hkv, s, d, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=g, device=device).to(dtype)
                 for h in (hq, hkv, hkv))


def ssd_inputs(device, b, s, h, p, n, dtype, seed):
    """x, dt = softplus(N(0, 1)), a = -exp(0.3 N(0, 1)), B, C = 0.5 N(0, 1):
    the reference kernel tests' distributions; x, B and C in ``dtype`` (as
    the Mamba block's convolution gives them), dt and a in fp32."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=device))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device=device))
    bm = (0.5 * torch.randn((b, s, n), generator=g, device=device)).to(dtype)
    cm = (0.5 * torch.randn((b, s, n), generator=g, device=device)).to(dtype)
    return x, dt, a, bm, cm


def lm_kernel_parity(device, *, attn_cases=ATTN_CASES, ssd_cases=SSD_CASES, seed: int = 0) -> dict:
    """Phase 9: K8 and K9 against their plain versions on ``device``, fp32
    and bf16; returns {kernel: worst fp32 max abs error}; raises past a
    tolerance (each scaled to max|ref|)."""
    from repro_torch.kernels import flash_attention_ops as fa
    from repro_torch.kernels import ssd_ops as so

    worst = {"flash_attention": 0.0, "ssd": 0.0}
    bad = []

    def check(name, tag, out, ref, tol, fp32, per_row=False):
        out, ref = out.float(), ref.float()
        err, scale = _err(out, ref)
        row_err = _row_err(out, ref) if per_row else 0.0
        log(f"parity {name}/{tag}: max_abs_err={err:.3e} tol={tol * scale:.3e} "
            f"max|ref|={scale:.3e}" + (f" row_err={row_err:.3e} row_tol={tol:.3e}"
                                       if per_row else ""))
        if fp32:
            worst[name] = max(worst[name], err)
        if out.shape != ref.shape or not err <= tol * scale:
            bad.append(f"{name}/{tag}: {err:.3e} > {tol * scale:.3e}")
        if not row_err <= tol:
            bad.append(f"{name}/{tag}: row error {row_err:.3e} > {tol:.3e}")

    for i, (b, hq, hkv, s, d, causal) in enumerate(attn_cases):
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            q, k, v = attention_inputs(device, b, hq, hkv, s, d, dtype, seed + i)
            tag = f"{b}x{hq}/{hkv}x{s}x{d}/{'causal' if causal else 'full'}/{str(dtype)[6:]}"
            check("flash_attention", tag, fa.flash_attention(q, k, v, causal=causal),
                  fa.flash_attention_reference(q, k, v, causal=causal),
                  ATTN_TOL if fp32 else ATTN_BF16_TOL, fp32, per_row=True)
            del q, k, v
    for i, (b, s, h, p, n, chunk) in enumerate(ssd_cases):
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            args = ssd_inputs(device, b, s, h, p, n, dtype, seed + 100 + i)
            y, st = so.ssd(*args, chunk=chunk)
            yr, sr = so.ssd_reference(*args, chunk=chunk)
            tag = f"{b}x{s}x{h}x{p}x{n}/chunk{chunk}/{str(dtype)[6:]}"
            tol = SSD_TOL if fp32 else SSD_BF16_TOL
            check("ssd", tag + "/y", y, yr, tol, fp32)
            check("ssd", tag + "/state", st, sr, tol, fp32)
            del args, y, st, yr, sr
    sync(device)
    if bad:
        raise PhaseError("LM kernel parity failed: " + "; ".join(bad))
    return worst


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def decode_vs_forward(device, cfg=None, *, prompt: int = 128, seed: int = 0) -> dict:
    """Phase 10: one prompt through ``prefill_logits`` (K8 + K9 on the card)
    against ``prompt`` ``decode_step`` calls (no kernel) on the same tokens,
    in fp32 with ``capacity_factor`` 16 so the forward drops no token (the
    reference test's setting). Counts reset before each and read after;
    gate: max|delta| <= 5e-3 max|logit|, K8 >= 1 and K9 >= 7 launches in the
    forward, none in the decode."""
    from repro_torch import kernels
    from repro_torch.models import LM
    from repro_torch.serving import prefill_logits

    cfg = cfg or lm_config(dtype="float32", capacity_factor=16.0)
    t0 = time.perf_counter()
    lm = LM(cfg, seed=seed, device=str(device))
    sync(device)
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g, device=device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    want = prefill_logits(lm, {"tokens": tokens}).float()
    sync(device)
    forward_s = time.perf_counter() - t0
    fwd_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    cache = lm.init_cache(1, prompt)
    t0 = time.perf_counter()
    for t in range(prompt):
        got = lm.decode_step(cache, tokens[:, t], t, length=t + 1)
    sync(device)
    decode_s = time.perf_counter() - t0
    dec_launches = kernels.launch_counts()
    err, scale = _err(got.float(), want)
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_mamba = cfg.n_layers - n_attn
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "capacity_factor": cfg.capacity_factor, "prompt": prompt,
           "params": sum(p.numel() for p in lm.parameters()), "init_s": init_s,
           "forward_s": forward_s, "decode_s": decode_s, "max_abs_delta": err,
           "max_logit": scale, "delta_over_max": err / scale,
           "forward_launches": {n: fwd_launches[n] for n in LM_KERNELS},
           "decode_launches": {n: dec_launches[n] for n in LM_KERNELS},
           "launches": fwd_launches}
    log(f"decode vs forward: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}")
    del lm, cache, want, got
    _free(device)
    bad = []
    if not err <= DECODE_TOL * scale:
        bad.append(f"decode differs from the forward by {err:.3e} > {DECODE_TOL} x {scale:.3e}")
    if torch.device(device).type == "cuda":
        if fwd_launches["flash_attention"] < n_attn or fwd_launches["ssd"] < n_mamba:
            bad.append(f"the forward launched K8 {fwd_launches['flash_attention']} and K9 "
                       f"{fwd_launches['ssd']} times (want >= {n_attn} and >= {n_mamba})")
    if any(dec_launches[n] for n in LM_KERNELS):
        bad.append(f"the decode launched an LM kernel: {res['decode_launches']}")
    if bad:
        raise PhaseError("decode vs forward failed: " + "; ".join(bad))
    return res


def _ops_ms(contractions: float, elementwise: float, tensor_cores: bool) -> float:
    """Least ms for the operations: the contractions over the bf16
    tensor-core peak (``tensor_cores``) or the fp32 peak, the elementwise
    work over the fp32 peak, the two times added."""
    peak = PEAK_BF16_TENSOR_FLOPS if tensor_cores else PEAK_FP32_FLOPS
    return (contractions / peak + elementwise / PEAK_FP32_FLOPS) * 1e3


def attention_bound(b, hq, hkv, s, d, causal, itemsize, *,
                    tensor_cores: bool | None = None) -> tuple[float, str]:
    """(least ms, bound) for K8: q, k, v read and the output written once;
    per unmasked (query, key) pair 4 D operations in the two contractions
    and 4 in the softmax (max, subtract, exp, sum). With bf16 operands
    (``itemsize`` 2; ``tensor_cores`` overrides) the contractions go over
    the bf16 tensor-core peak, as a flash attention on the tensor cores
    (scaled_dot_product_attention) runs them; with fp32 operands over the
    fp32 peak."""
    if tensor_cores is None:
        tensor_cores = itemsize == 2
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = itemsize * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = _ops_ms(b * hq * pairs * 4 * d, b * hq * pairs * 4, tensor_cores)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_states_bytes(b, s, h, p, n, chunk) -> int:
    """Bytes of K9's chunk states, (B, ceil(S / chunk), H, P, N) fp32."""
    return 4 * b * -(-s // chunk) * h * p * n


def ssd_bound(b, s, h, p, n, chunk, itemsize, *, tensor_cores: bool | None = None,
              design: bool = False) -> tuple[float, str]:
    """(least ms, bound) for K9 at ``chunk``: x, B, C read and y written
    once in their dtype (``itemsize``), dt read and the state written once
    in fp32. Contractions per chunk of Q rows: C B^T once per batch row (2 N
    per pair k <= q); per head y_diag (2 P per pair), y_off and the state
    (2 P N per row each). Elementwise per head: L and C B^T * L (3 per
    pair), the decays of y_off and of dt x (2 P per row), the state's decay
    and sum (2 P N). Contractions over the bf16 tensor-core peak with bf16 operands
    (``tensor_cores`` overrides), else over the fp32 peak. ``design`` adds
    the bytes ssd.cu's three launches move beyond one pass: the chunk states
    written, read, rewritten and read (4 x ``ssd_states_bytes``), their
    decays written and read, and x, B and dt read a second time."""
    if tensor_cores is None:
        tensor_cores = itemsize == 2
    nbytes = itemsize * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    if design:
        nbytes += (4 * ssd_states_bytes(b, s, h, p, n, chunk) + 2 * 4 * b * -(-s // chunk) * h
                   + itemsize * (b * s * h * p + b * s * n) + 4 * b * s * h)
    contractions = elementwise = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        contractions += b * 2 * n * pairs + b * h * (pairs * 2 * p + q * 4 * p * n)
        elementwise += b * h * (pairs * 3 + q * 2 * p + 2 * p * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = _ops_ms(contractions, elementwise, tensor_cores)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve(device, cfg=None, *, batch: int = 4, prompt: int = 2048, repeats: int = 3,
          slots: int = 4, max_len: int = 256, serve_prompt: int = 32, steps: int = 32,
          join_at: int = 8, seed: int = 0) -> dict:
    """Phase 11, in the model's dtype: ``prefill_logits`` on ``batch`` prompts
    of ``prompt`` tokens timed warm (prefill tokens/s), then ServeEngine with
    ``slots`` slots: three requests of ``serve_prompt`` tokens start, a
    fourth joins after ``join_at`` steps, ``steps`` decode steps (decode
    tokens/s). Counts reset before the prefill and read after the serving.
    Then K8 and K9 at the shapes the prefill gives them (``lm_kernel_times``).
    Gates: finite logits, each slot's output as long as its steps."""
    from repro_torch import kernels
    from repro_torch.models import LM, mamba2
    from repro_torch.models.model import model_dtype
    from repro_torch.serving import ServeEngine, prefill_logits

    cfg = cfg or lm_config()
    on_card = torch.device(device).type == "cuda"
    lm = LM(cfg, seed=seed, device=str(device))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=device)
    logits = prefill_logits(lm, {"tokens": tokens})  # warm-up
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(repeats):
        logits = prefill_logits(lm, {"tokens": tokens})
    sync(device)
    prefill_s = (time.perf_counter() - t0) / repeats
    finite = bool(torch.all(torch.isfinite(logits.float())))

    eng = ServeEngine(lm, max_len=max_len, batch_slots=slots, device=str(device))
    prompts = torch.randint(0, cfg.vocab_size, (slots, serve_prompt),
                            generator=torch.Generator().manual_seed(seed + 2)).tolist()
    t0 = time.perf_counter()
    for slot in range(slots - 1):
        eng.add_request(slot, prompts[slot])
    sync(device)
    add_s = time.perf_counter() - t0
    decode_s, decoded = 0.0, 0
    for i in range(steps):
        if i == join_at:
            t0 = time.perf_counter()
            eng.add_request(slots - 1, prompts[slots - 1])
            sync(device)
            add_s += time.perf_counter() - t0
        active = int(eng.active.sum())
        t0 = time.perf_counter()
        eng.step()
        sync(device)
        decode_s += time.perf_counter() - t0
        decoded += active
    launches = kernels.launch_counts()
    last = lm.decode_step(eng.cache, eng.tokens, eng.pos, length=eng.pos + 1)
    finite = finite and bool(torch.all(torch.isfinite(last.float())))
    outputs = [eng.finish(s) for s in range(slots)]
    want_len = [1 + steps] * (slots - 1) + [1 + steps - join_at]
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
           "prompt": prompt, "prefill_s": prefill_s, "prefill_tokens_per_s":
           batch * prompt / prefill_s, "serve_slots": slots, "serve_prompt": serve_prompt,
           "decode_steps": steps, "decode_s": decode_s, "decode_tokens_per_s": decoded / decode_s,
           "decode_ms_per_step": decode_s / steps * 1e3, "add_request_s": add_s,
           "logits_finite": finite, "output_lengths": [len(o) for o in outputs],
           "launches": launches}
    log(f"serve: {json.dumps({k: v for k, v in res.items() if k != 'launches'})}")
    for s, out in enumerate(outputs):
        log(f"serve slot {s}: {json.dumps(out)}")

    del eng, logits, last, lm
    _free(device)
    # K8 and K9 at the prefill's shapes: Jamba's attention layer and Mamba layer
    res["kernels"] = lm_kernel_times(
        device, (batch, cfg.n_heads, cfg.n_kv_heads, prompt, cfg.head_dim),
        (batch, prompt, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), mamba2.CHUNK,
        model_dtype(cfg), seed=seed, timed=on_card)
    _free(device)
    bad = []
    if not finite:
        bad.append("non-finite logits")
    if res["output_lengths"] != want_len:
        bad.append(f"output lengths {res['output_lengths']}, want {want_len}")
    if on_card and not (launches["flash_attention"] >= 1 and launches["ssd"] >= 1):
        bad.append(f"kernels not launched on the serving path: "
                   f"{ {n: launches[n] for n in LM_KERNELS} }")
    if bad:
        raise PhaseError("serve failed: " + "; ".join(bad))
    return res


def lm_kernel_times(device, attn_shape, ssd_shape, chunk, dtype, *, seed: int = 0,
                    timed: bool = True, repeats: int = 5, plain_repeats: int = 2,
                    default_chunk: int = 128) -> dict:
    """K8 (causal) at ``attn_shape`` (B, Hq, Hkv, S, D) and K9 at
    ``ssd_shape`` (B, S, H, P, N) and ``chunk``, on phase 9's inputs in
    ``dtype``: parity with the plain version (phase 9's tolerances) and, if
    ``timed``, CUDA-event times of kernel, plain version and library call
    (SDPA for K8; none for K9) beside the bound (K9: the one-pass bound and
    its design's, which counts the chunk states). K9 is also checked and
    timed at the wrapper's ``default_chunk``."""
    def ms(fn, r):
        return _cuda_ms(fn, r) if timed else None

    from repro_torch.kernels import flash_attention_ops as fa
    from repro_torch.kernels import ssd_ops as so

    bf16 = dtype == torch.bfloat16
    out, bad = {}, []
    b, hq, hkv, s, d = attn_shape
    q, k, v = attention_inputs(device, b, hq, hkv, s, d, dtype, seed)
    o, r = (fa.flash_attention(q, k, v, causal=True).float(),
            fa.flash_attention_reference(q, k, v, causal=True).float())
    (err, scale), row_err = _err(o, r), _row_err(o, r)
    del o, r
    row_tol = ATTN_BF16_TOL if bf16 else ATTN_TOL
    tol = row_tol * scale
    if not err <= tol:
        bad.append(f"flash_attention: {err:.3e} > {tol:.3e}")
    if not row_err <= row_tol:
        bad.append(f"flash_attention: row error {row_err:.3e} > {row_tol:.3e}")
    b_ms, b_by = attention_bound(b, hq, hkv, s, d, True, q.element_size())
    out["flash_attention"] = {
        "shape": list(attn_shape), "dtype": str(dtype)[6:], "causal": True,
        "design": "mma.sync bf16" if bf16 else "fp32 FMA", "max_abs_err": err, "tol": tol,
        "row_err": row_err, "row_tol": row_tol,
        "ms": ms(lambda: fa.flash_attention(q, k, v, causal=True), repeats),
        "plain_ms": ms(lambda: fa.flash_attention_reference(q, k, v, causal=True),
                       plain_repeats),
        "library_ms": ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), repeats),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_fp32_ms": attention_bound(b, hq, hkv, s, d, True, q.element_size(),
                                         tensor_cores=False)[0]}
    del q, k, v
    bsz, sl, h, p, n = ssd_shape
    args = ssd_inputs(device, bsz, sl, h, p, n, dtype, seed + 100)
    stol = SSD_BF16_TOL if bf16 else SSD_TOL
    for c in (chunk, default_chunk):
        y, st = so.ssd(*args, chunk=c)
        yr, sr = so.ssd_reference(*args, chunk=c)
        (ey, sy), (es, ss) = _err(y.float(), yr.float()), _err(st, sr)
        del y, st, yr, sr
        if not (ey <= stol * sy and es <= stol * ss):
            bad.append(f"ssd/chunk{c}: y {ey:.3e} (tol {stol * sy:.3e}), state {es:.3e} "
                       f"(tol {stol * ss:.3e})")
        b_ms, b_by = ssd_bound(bsz, sl, h, p, n, c, args[0].element_size())
        d_ms, d_by = ssd_bound(bsz, sl, h, p, n, c, args[0].element_size(), design=True)
        out["ssd" if c == chunk else f"ssd_chunk{c}"] = {
            "shape": list(ssd_shape), "chunk": c, "dtype": str(dtype)[6:],
            "max_abs_err": max(ey, es), "y_err": ey, "y_tol": stol * sy, "state_err": es,
            "state_tol": stol * ss, "ms": ms(lambda: so.ssd(*args, chunk=c), repeats),
            "plain_ms": ms(lambda: so.ssd_reference(*args, chunk=c), plain_repeats),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_ms": ssd_bound(bsz, sl, h, p, n, c, args[0].element_size(),
                                       tensor_cores=False)[0],
            "design_bound_ms": d_ms, "design_bound_by": d_by,
            "states_bytes": ssd_states_bytes(bsz, sl, h, p, n, c)}
        if c == chunk == default_chunk:
            break
    for name, t in out.items():
        log(f"times {name}: {json.dumps(t)}")
    if bad:
        raise PhaseError("LM kernels at the main path's shapes: " + "; ".join(bad))
    return out


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
        bless_t = fb.pop("tensors")
        calls = main_path_calls(tensors, sigma=4.0, bless_t=bless_t, seed=args.seed)
        errs = main_path_parity(calls)
        times = kernel_times(calls)
        del calls
        crossovers("cuda", times, seed=args.seed)
        cv = cross_validation("cuda", tensors, bless_t["center_set"], seed=args.seed)
        clf = classify("cuda", tensors, bless_t["center_set"], fb["test_error"], seed=args.seed)
        krr = krr_online("cuda", tensors, bless_t, seed=args.seed)
        del tensors, bless_t  # the LM phases need the card's memory
        _free("cuda")
        lm_worst = lm_kernel_parity("cuda", seed=args.seed)
        dvf = decode_vs_forward("cuda", seed=args.seed)
        srv = serve("cuda", seed=args.seed)
    except PhaseError as e:
        print(f"chip_smoke: FAIL {e}", file=sys.stderr)
        return 1
    # launches: the main paths' counts added (each reset just before its path):
    # the four FALKON paths and phase 12's serving / streaming / online work
    # for K1-K7, the LM forward of phase 10 and the prefill + serving of
    # phase 11 for K8 and K9
    paths = (e2e, fb, cv, clf, krr, dvf, srv)
    launches = {name: sum(p["launches"][name] for p in paths) for name in {**KERNELS,
                                                                             **LM_KERNELS}}
    for name in LM_KERNELS:
        errs[name] = srv["kernels"][name]["max_abs_err"]
        times[name] = srv["kernels"][name]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name, (src, tpu) in {**KERNELS, **LM_KERNELS}.items()]}
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
    log(f"k-fold CV: sweep {cv['sweep_s']:.3f} s for {cv['folds']} folds x {len(cv['lams'])} "
        f"lams at M = {cv['m']} (K7 {cv['launches']['falkon_matvec_masked']} launches), best "
        f"lam {cv['best_lam']:g}; one naive refit {cv['naive_refit_s']:.3f} s, naive grid "
        f"estimate {cv['naive_grid_estimate_s']:.3f} s; mask tax {cv['mask_tax']['ratio']:.4f}; "
        f"classifier fit {clf['fit_s']:.3f} s, accuracy {clf['accuracy']:.5f} against "
        f"{clf['one_minus_bless_error']:.5f}; launches CV path {json.dumps(cv['launches'])}, "
        f"classifier path {json.dumps(clf['launches'])}")
    log(f"KRR serving: {krr['serve']['requests_per_s']:.1f} requests/s, "
        f"{krr['serve']['rows_per_s']:.1f} rows/s in {krr['serve']['dispatches']} waves "
        f"(buckets {krr['serve']['buckets']}, {krr['serve']['padded_rows']} padded rows, K4 "
        f"{krr['serve']['launches']['knm_matvec']} launches); async "
        f"{krr['async']['requests_per_s']:.1f} requests/s, p99 wave {krr['async']['p99_wave_s']} s; "
        f"streamed fit {krr['stream']['fit_s']:.3f} s (test error {krr['stream']['test_error']:.5f}, "
        f"peak {krr['stream']['peak_bytes_above_base']} B above base), durable fit {krr['durable']['fit_s']:.3f} s (resume "
        f"{krr['durable']['resume_s']:.3f} s, bit-identical {krr['durable']['bit_identical']}, "
        f"test error {krr['durable']['test_error']:.5f}); online refit median "
        f"{sorted(krr['online']['refit_ms'])[len(krr['online']['refit_ms']) // 2]:.2f} ms; launches "
        f"{json.dumps({k: v for k, v in krr['launches'].items() if v})}")
    # kernel time inside phase 12's wall times: launches x phase 6's CUDA-event
    # ms at the same shapes (the full wave and the full chunk: an upper bound,
    # as the last wave and chunk are smaller)
    k4_ms, k1_ms = times["knm_matvec@wave"]["ms"], times["gram@stream"]["ms"]
    log(f"krr-online kernel share: serving K4 {krr['serve']['launches']['knm_matvec']} x "
        f"{k4_ms:.4f} ms <= {krr['serve']['launches']['knm_matvec'] * k4_ms:.3f} ms of "
        f"{1e3 * krr['serve']['seconds']:.3f} ms wall; streamed fit K1 "
        f"{krr['stream']['launches']['gram']} x {k1_ms:.4f} ms <= "
        f"{krr['stream']['launches']['gram'] * k1_ms / 1e3:.4f} s of {krr['stream']['fit_s']:.4f} s; "
        f"fp64 referee distances {json.dumps(krr['referee'])}")
    log(f"LM (Jamba, {dvf['n_layers']} layers at full width): decode vs forward "
        f"{dvf['delta_over_max']:.3e} of max|logit| in fp32; prefill "
        f"{srv['prefill_tokens_per_s']:.1f} tokens/s ({srv['batch']} x {srv['prompt']}, bf16), "
        f"decode {srv['decode_tokens_per_s']:.2f} tokens/s ({srv['decode_ms_per_step']:.2f} ms "
        f"per step, {srv['serve_slots']} slots); K8 {srv['kernels']['flash_attention']['ms']:.4f} "
        f"ms, K9 {srv['kernels']['ssd']['ms']:.4f} ms per call (at the wrapper's default chunk 128: "
        f"{srv['kernels']['ssd_chunk128']['ms']:.4f} ms, plain "
        f"{srv['kernels']['ssd_chunk128']['plain_ms']:.4f} ms)")
    log(f"parity at ragged shapes, worst fp32 max_abs_err: "
        f"{json.dumps({**parity_worst, **lm_worst})}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
