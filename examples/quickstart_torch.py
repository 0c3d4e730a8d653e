"""Quickstart on the PyTorch / H100 port: the ``repro_torch.api`` front door
-- pluggable sampler, sklearn-style estimator, swappable kernel family.

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch

The counterpart of ``examples/quickstart.py``. On the card the contractions
are the hand-written CUDA kernels (BLESS scores through K5, the fits through
K1/K2/K3, predictions through K4, the k-fold sweep through K7); without a
card the default device raises instead of falling back to the CPU. Pin a
backend without code edits through ``REPRO_BACKEND`` (``cuda``, ``sharded``,
``stream``, ...). The data comes from ``--seed`` through numpy.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import (BlessSampler, ExactRlsSampler, FalkonRegressor, FitConfig,
                             KFoldSweep, kernel_family_names, make_kernel)
from repro_torch.core import approx_rls_all, exact_rls
from repro_torch.core.backend import backend_for_device, require_cuda_device

#: the sampler's regularization (the solver's is LAM_FALKON)
LAM = 1e-3
LAM_FALKON = 1e-5
ITERS = 25
SWEEP_LAMS = (1e-3, 1e-5, 1e-7)


def clustered(n: int, d: int = 8, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Clustered inputs, so a low effective dimension (the regime leverage
    scores are built for): 10 centers, n points around them, and a smooth
    target with a little noise. fp32 numpy arrays (n, d) and (n,)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((10, d)) * 3.0
    x = centers[rng.integers(0, 10, n)] + 0.4 * rng.standard_normal((n, d))
    y = np.sin(2 * x[:, 0]) * np.tanh(x[:, 1]) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32), y.astype(np.float32)


def bless_ladder(x: torch.Tensor, kern, seed: int) -> dict:
    """Step 1, BLESS (Alg. 1) over the whole lambda path, and step 2 its
    scores' accuracy: R-ACC of the final level's Eq. 3 scores against the
    exact ones (the O(n^3) oracle, for demonstration only)."""
    be = backend_for_device(x.device)  # the CUDA kernels on the card, plain torch on the CPU
    res = BlessSampler(lam=LAM, q1=4.0, q2=4.0).ladder(seed + 1, x, kern, backend=be)
    racc = approx_rls_all(kern, x, res.final.centers, LAM, backend=be) / exact_rls(kern, x, LAM)
    return {"levels": len(res.levels), "m": int(res.final.m_h), "d_eff": float(res.final.d_h),
            "racc_mean": float(racc.mean()),
            "racc_5": float(torch.quantile(racc, 0.05)),
            "racc_95": float(torch.quantile(racc, 0.95))}


def falkon_bless(kern, device: str, *, seed: int = 2) -> FalkonRegressor:
    """Step 3's estimator, FALKON-BLESS: the sampler slot and the estimator
    slot composed (fit it, or pass ``center_set=`` to skip the sampler)."""
    return FalkonRegressor(kernel=kern, sampler=BlessSampler(lam=1e-3, q2=3.0, m_cap=400),
                           config=FitConfig(lam=LAM_FALKON, iters=ITERS, seed=seed,
                                            device=device))


def oracle_matern(device: str) -> FalkonRegressor:
    """Step 4's estimator: the slots are swappable -- the exact-RLS oracle
    sampler, another kernel family."""
    return FalkonRegressor(kernel="matern32", sigma=2.0, sampler=ExactRlsSampler(m=300, lam=LAM),
                           config=FitConfig(lam=LAM_FALKON, iters=ITERS, seed=3, device=device))


def multi_output_targets(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Step 5's k = 3 targets: they ride ONE multi-RHS block-CG, so the
    extra outputs cost products with K_nM, not extra kernel evaluations."""
    return np.stack([y, np.cos(x[:, 2]) * x[:, 0], -0.5 * y + 1.0], axis=1).astype(np.float32)


def kfold_sweep(kern, device: str, *, lams=SWEEP_LAMS, iters: int = ITERS) -> KFoldSweep:
    """Step 6's sweep: per lambda ONE multi-RHS solve (folds = columns,
    fold-masked targets) on shared centers."""
    return KFoldSweep(kernel=kern, sampler=BlessSampler(lam=1e-3, m_cap=400), lams=lams,
                      folds=5, iters=iters, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and the samplers")
    ap.add_argument("--device", default="cuda", help="cuda (the card; the default) or cpu")
    args = ap.parse_args(argv)

    x_np, y_np = clustered(args.n, seed=args.seed)
    dev = require_cuda_device(args.device)  # raises without a card: no fallback
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    kern = make_kernel("gaussian", sigma=2.0)
    out = {}

    out["bless"] = b = bless_ladder(x, kern, args.seed)
    print(f"BLESS: {b['levels']} ladder levels, final |J| = {b['m']} (d_eff estimate "
          f"{b['d_eff']:.1f})")
    print(f"score accuracy: mean R-ACC {b['racc_mean']:.3f}, 5th/95th pct {b['racc_5']:.2f}/"
          f"{b['racc_95']:.2f}")

    est = falkon_bless(kern, args.device).fit(x, y)
    mse = float(torch.mean((est.predict(x) - y) ** 2))
    out["falkon_bless"] = {"m": int(est.centers_.shape[0]), "mse": mse, "r2": est.score(x, y)}
    print(f"FALKON-BLESS: M = {est.centers_.shape[0]} centers, train MSE {mse:.4f} "
          f"(R^2 {out['falkon_bless']['r2']:.3f})")

    oracle = oracle_matern(args.device).fit(x, y)
    out["matern32_oracle"] = {"r2": oracle.score(x, y)}
    print(f"matern32 + exact-RLS oracle sampler: R^2 {out['matern32_oracle']['r2']:.3f} "
          f"(families available: {kernel_family_names()})")

    ys = torch.from_numpy(multi_output_targets(x_np, y_np)).to(dev)
    multi = falkon_bless(kern, args.device).fit(x, ys)
    out["multi_output"] = {"alpha_shape": list(multi.model_.alpha.shape), "r2": multi.score(x, ys)}
    print(f"multi-output: alpha {tuple(multi.model_.alpha.shape)}, predict "
          f"{tuple(multi.predict(x[:5]).shape)}, R^2 {out['multi_output']['r2']:.3f}")

    res = kfold_sweep(kern, args.device).run(x, y)
    scores = [float(s) for s in res.mean_scores]
    out["kfold"] = {"lams": list(res.lams), "mean_scores": scores, "best_lam": res.best_lam}
    shown = ", ".join(f"lam={lam:g}: {s:.4f}" for lam, s in zip(res.lams, scores))
    print(f"KFoldSweep held-out MSE ({shown}) -> best lam {res.best_lam:g} "
          f"[{len(res.lams)} solves instead of {len(res.lams) * 5} fits]")
    return out


if __name__ == "__main__":
    main()
