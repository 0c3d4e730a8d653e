#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's FALKON fit-and-predict path on one H100.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without one

Phases (each a plain function, so a CPU test can rehearse them at a tiny size):

  1. probe      card name, capability (must be (9, 0)), nvidia-smi name and
                power limit, CUDA version; TF32 off for matmuls and cuDNN.
  2. build      compile every CUDA kernel from the sources in this checkout.
  3. parity     each kernel (K1 gram, K2 falkon_matvec, K3 knm_t, K4
                knm_matvec) against its plain PyTorch version on the card, at
                ragged shapes (n = 70 001, M = 1 000, d = 18, k vector and 3),
                all five kernel families, plus bf16 on the gaussian family.
  4. end to end FalkonRegressor + UniformSampler at the scale of the paper's
                SUSY experiment (d = 18, n_train = 10^6 cut from 5 * 10^6 for
                the time limit, n_test = 10^5, M = 10^4, sigma = 4, lam = 1e-6,
                20 CG iterations), on synthetic data from --seed; the kernels'
                launch counts are reset just before and read just after. Then
                refits on the first 65 536 rows with the same centers and the
                same lam: CudaBackend and TorchBackend in fp32, both on the
                card, refereed by a TorchBackend refit in fp64; the CUDA
                refit's predictions must lie no farther from the referee's
                than the fp32 TorchBackend's do, plus 1e-3 of max|pred|, and
                must agree to 1e-3 with a TorchBackend refit given K1's K_MM.
  5. times      each kernel at the shapes phase 4 gave it, against its plain
                version there (tolerance checked again), timed with CUDA
                events beside its bound and a PyTorch yardstick call.

Tolerances: Gram 2e-5 absolute; K_nM contractions 1e-4 * max|ref|; bf16
3e-2 * max|ref|; end-to-end predictions 1e-3 * max|pred| (beyond the fp32
TorchBackend's own distance from the fp64 referee, and against TorchBackend
on one K_MM). Any failed phase
exits non-zero. The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}.
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
}


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


def kernel_parity(device, *, n: int = 70_001, m: int = 1_000, d: int = 18, k: int = 3,
                  sigma: float = 4.0, seed: int = 0) -> dict:
    """Every kernel against its plain version on ``device``; returns
    {kernel: max abs error over the fp32 cases}; raises past a tolerance."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go

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
    if bad:
        raise PhaseError("kernel parity failed: " + "; ".join(bad))
    return worst


# ---------------------------------------------------------------------------
# 4. end to end
# ---------------------------------------------------------------------------


def end_to_end(device, *, n_train: int = 1_000_000, n_test: int = 100_000, m: int = 10_000,
               d: int = 18, iters: int = 20, sigma: float = 4.0, lam: float = 1e-6,
               refit_rows: int = 65_536, seed: int = 0,
               max_error: float = 0.2) -> dict:
    """Fit and predict through the front door with the launch counts reset
    just before and read just after; then the CudaBackend / TorchBackend
    refit agreement. Returns the metrics and the tensors phase 5 reuses."""
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
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None

    if pred.shape != (n_test,) or not bool(torch.all(torch.isfinite(pred))):
        raise PhaseError(f"predictions: shape {tuple(pred.shape)}, finite "
                         f"{bool(torch.all(torch.isfinite(pred)))}")
    test_error = float(torch.mean((torch.sign(pred) != yte).float()))
    reduction = float(est.model_.diagnostics.reduction.max())
    res = {"n_train": n_train, "n_test": n_test, "m": m, "d": d, "iters": iters,
           "fit_s": fit_s, "predict_s": predict_s, "test_error": test_error,
           "cg_residual_reduction": reduction, "launches": launches,
           "peak_bytes": peak, "knm_bytes": 4 * n_train * m}
    log(f"end_to_end: {json.dumps(res)}")
    if not test_error < max_error:
        raise PhaseError(f"test error {test_error:.4f} is not below {max_error}")
    if not reduction < 1e-2:
        raise PhaseError(f"CG reduced the squared residual only to {reduction:.3e}")
    if peak is not None and not peak < 0.25 * res["knm_bytes"]:
        raise PhaseError(f"peak device memory {peak} B is not far below K_nM's "
                         f"{res['knm_bytes']} B")
    if torch.device(device).type == "cuda":
        missing = [name for name, count in launches.items() if count == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the main path: {missing}")

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
    res["tensors"] = {"x": xtr, "z": est.centers_, "xte": xte, "y": ytr,
                      "alpha": est.model_.alpha}
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
# 5. kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def bound(name: str, n: int, m: int, d: int, k: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for one call.

    Bytes: each input read once, each output written once (fp32). Operations:
    the Gram values computed once, 2d for x.z plus 3 for the distance
    (add, fma, clamp) plus 2 for the gaussian epilogue (mul, exp), and 2 per
    multiply-add of each contraction against k columns (falkon_matvec has
    two). Over the fp32 peak and the HBM rate of the data sheet.
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
    else:
        raise ValueError(name)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_call(name: str, x, z, v, s: float, block: int = 16_384):
    """One PyTorch yardstick for the same function (cdist + exp + matmul),
    row-blocked where the whole K_nM would not fit. Never used by the port."""
    def g(xb):
        return torch.exp(-torch.cdist(xb, z).square() * s)
    if name == "gram":
        return g(z)
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


def main_path_calls(t: dict, sigma: float):
    """(name, n, m, d, k, kernel call, plain call, library call) for each kernel
    at the shapes the main path gave it: K1 builds K_MM, K2 and K3 run on the
    training rows with a vector, K4 predicts the test rows."""
    from repro_torch.kernels import falkon_matvec_ops as fo
    from repro_torch.kernels import gram_ops as go

    x, z, xte, y, alpha = t["x"], t["z"], t["xte"], t["y"], t["alpha"]
    n, d = x.shape
    m = z.shape[0]
    s = 1.0 / (2.0 * sigma ** 2)
    v = alpha
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
    ]


def main_path_parity(calls) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    errs = {}
    bad = []
    for name, n, m, d, k, kern, plain, _ in calls:
        out, ref = kern(), plain()
        err, scale = _err(out, ref)
        tol = GRAM_TOL if name == "gram" else KNM_TOL * scale
        errs[name] = err
        log(f"parity@main {name} (n={n}, M={m}, d={d}): max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            bad.append(f"{name}: {err:.3e} > {tol:.3e}")
        del out, ref
    if bad:
        raise PhaseError("main-path parity failed: " + "; ".join(bad))
    return errs


def kernel_times(calls, *, repeats: int = 5, plain_repeats: int = 2) -> dict:
    """CUDA-event times of each kernel, its plain version and the yardstick."""
    times = {}
    for name, n, m, d, k, kern, plain, library in calls:
        b_ms, b_by = bound(name, n, m, d, k)
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
        calls = main_path_calls(e2e.pop("tensors"), sigma=4.0)
        errs = main_path_parity(calls)
        times = kernel_times(calls)
    except PhaseError as e:
        print(f"chip_smoke: FAIL {e}", file=sys.stderr)
        return 1
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": e2e["launches"][name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name in KERNELS]}
    kernel_s = sum(e2e["launches"][n] * times[n]["ms"] for n in ("gram", "falkon_matvec",
                                                                  "knm_t")) / 1e3
    log(f"fit: {e2e['fit_s']:.3f} s, of which kernels {kernel_s:.3f} s (launches x ms), "
        f"preconditioner {e2e['breakdown']['preconditioner_s']:.3f} s, sampler "
        f"{e2e['breakdown']['sample_s']:.3f} s")
    log(f"parity at ragged shapes, worst fp32 max_abs_err: {json.dumps(parity_worst)}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
