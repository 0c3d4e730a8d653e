"""End-to-end run on the PyTorch / H100 port (the paper's kind of
workload): large-scale kernel ridge classification with the full pipeline --

  BLESS center selection -> data-parallel FALKON CG (one rank a card over
  NCCL under torchrun; one rank otherwise) -> evaluation -> checkpoint.

Mirrors the paper's SUSY experiment shape (Sec. 4): n = 50 000 points,
lam_bless >> lam_falkon, ~10^2-10^3 Nystrom centers.

    PYTHONPATH=src python examples/falkon_endtoend_torch.py [--n 50000] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/falkon_endtoend_torch.py

The counterpart of ``examples/falkon_endtoend.py``: the reference's
``data_mesh()`` is ``repro_torch.core.distributed.data_group()``, the
process group ``torchrun`` describes (``launch.mesh.init_from_env``: NCCL
when each rank has a card of its own, gloo on the CPU); without one the fit
runs on one rank. Every rank holds the whole data and keeps its own rows;
rank 0 writes the checkpoint. On the card the contractions are the CUDA
kernels (K5 in BLESS, K1/K2/K3 in the fit, K4 in predict); without a card
the default device raises. The data comes from ``--seed`` through numpy.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig, make_kernel
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.backend import backend_for_device, require_cuda_device
from repro_torch.core.distributed import data_group, falkon_fit_distributed, world
from repro_torch.launch.mesh import init_from_env, rank_device

N_TEST = 8000
SIGMA = 4.0  # the paper's SUSY sigma


def susy_like(n: int, d: int = 18, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Two-class data with SUSY-ish dimensionality: a smooth nonlinear
    decision boundary on a low-dimensional subspace plus nuisance dims (the
    low-effective-dimension regime leverage scores exploit). fp32 numpy
    arrays (n, d) and (n,) of +-1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    w1, w2 = rng.standard_normal((2, d)) / np.sqrt(d)
    margin = np.tanh(2 * x @ w1) + 0.5 * (x @ w2) ** 2 - 0.5
    y = np.sign(margin + 0.1 * rng.standard_normal(n))
    return x.astype(np.float32), np.where(y == 0, 1.0, y).astype(np.float32)


def fit(x: torch.Tensor, y: torch.Tensor, *, lam_bless: float = 1e-4, lam_falkon: float = 1e-6,
        iters: int = 20, m_cap: int = 1500, backend: str | None = None, seed: int = 0) -> dict:
    """BLESS, then FALKON on its centers: on the process group's ranks
    (``backend`` None or "sharded"), else through ``FalkonRegressor`` on the
    named backend. Returns {"model", "ladder", "bless_s", "falkon_s", "world"}."""
    kern = make_kernel("gaussian", sigma=SIGMA)
    group = data_group()
    sampler = BlessSampler(lam=lam_bless, q1=3.0, q2=3.0, m_cap=m_cap)
    t0 = time.perf_counter()
    res = sampler.ladder(seed, x, kern, backend=backend or backend_for_device(x.device,
                                                                               n=x.shape[0]))
    bless_s = time.perf_counter() - t0
    m = res.final.m_h
    centers = res.final.centers
    t0 = time.perf_counter()
    if backend is None or backend == "sharded":
        model = falkon_fit_distributed(group, kern, x, y, x[centers.idx[:m].to(x.device)],
                                       lam_falkon, a_diag=centers.weight[:m].to(x.device),
                                       iters=iters)
    else:
        est = FalkonRegressor(kernel=kern, sampler=sampler, config=FitConfig(
            lam=lam_falkon, iters=iters, backend=backend, device=str(x.device)))
        model = est.fit(x, y, center_set=centers).model_  # the ladder above already sampled
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    return {"model": model, "ladder": res, "bless_s": bless_s,
            "falkon_s": time.perf_counter() - t0, "world": world(group)[1]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--lam-bless", type=float, default=1e-4)
    ap.add_argument("--lam-falkon", type=float, default=1e-6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--m-cap", type=int, default=1500)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "falkon_ckpt"))
    ap.add_argument("--backend", choices=["auto", "torch", "cuda", "sharded", "stream"],
                    default="auto", help="kernel-operator backend (auto: the device's for "
                    "BLESS, FALKON data-parallel over the process group)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and the sampler")
    ap.add_argument("--device", default="cuda", help="cuda (the card; the default) or cpu")
    args = ap.parse_args(argv)
    backend = None if args.backend == "auto" else args.backend

    dev_type = require_cuda_device(args.device).type  # raises without a card: no fallback
    owns_group = not dist.is_initialized() and init_from_env(dev_type)
    try:
        dev = rank_device(dev_type) if dist.is_initialized() else torch.device(args.device)
        xa, ya = susy_like(args.n + N_TEST, seed=args.seed)  # one rule; held-out split
        x, y = torch.from_numpy(xa[:args.n]).to(dev), torch.from_numpy(ya[:args.n]).to(dev)
        xte, yte = torch.from_numpy(xa[args.n:]).to(dev), torch.from_numpy(ya[args.n:]).to(dev)
        rank = world(data_group())[0]
        r = fit(x, y, lam_bless=args.lam_bless, lam_falkon=args.lam_falkon, iters=args.iters,
                m_cap=args.m_cap, backend=backend, seed=args.seed)
        levels, model = r["ladder"].levels, r["model"]
        out = {"n": args.n, "m": levels[-1].m_h, "levels": len(levels), "world": r["world"],
               "bless_s": r["bless_s"], "falkon_s": r["falkon_s"],
               "max_candidates": max(lv.r_h for lv in levels)}
        if rank == 0:
            print(f"BLESS: {len(levels)} levels, M = {out['m']} centers in {r['bless_s']:.1f}s "
                  f"(n = {args.n}; candidate sets never exceeded {out['max_candidates']} "
                  "points -- the 1/lam bound)")
            print(f"FALKON: data-parallel CG over {r['world']} rank(s)" if backend in (None,
                  "sharded") else f"FALKON: CG on the {backend!r} backend")
        out["train_err"] = float(torch.mean((torch.sign(model.predict(x[:10_000]))
                                             != y[:10_000]).float()))
        out["test_err"] = float(torch.mean((torch.sign(model.predict(xte)) != yte).float()))
        if rank == 0:
            print(f"FALKON-BLESS: {args.iters} CG iters in {r['falkon_s']:.1f}s | train err "
                  f"{out['train_err']:.4f} | test err {out['test_err']:.4f}")
            out["ckpt"] = save_checkpoint(args.ckpt, 0, {
                "centers": model.centers, "alpha": model.alpha,
                "sigma": np.float32(SIGMA), "lam": np.float32(args.lam_falkon)})
            print(f"model checkpoint -> {out['ckpt']}")
        return out
    finally:
        if owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
