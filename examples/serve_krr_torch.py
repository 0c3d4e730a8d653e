"""Serve a FALKON-BLESS kernel ridge model under bursty request traffic on
the PyTorch / H100 port -- the paper's estimator as a production endpoint.

Fits FALKON-BLESS once, then replays a trace of variable-size prediction
requests through ``KrrServer``: requests are packed into waves, padded to
pow2 row buckets, and each wave is one ``knm_matvec`` (K4 on the card).
Compare the dispatch count with the one-dispatch-per-request path it
replaces.

    PYTHONPATH=src python examples/serve_krr_torch.py [--backend cuda|torch|sharded|stream]
    PYTHONPATH=src python examples/serve_krr_torch.py --device cpu

The counterpart of ``examples/serve_krr.py``; it runs on the card unless
given ``--device cpu`` and raises without a card. The data and the trace
come from ``--seed`` through numpy.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig, KrrServer, make_kernel
from repro_torch.core.backend import require_cuda_device

D = 8


def clustered(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, cluster centers): clustered inputs, the low-d_eff regime BLESS
    exploits, and a smooth target. fp32 numpy."""
    rng = np.random.default_rng(seed)
    cl = rng.standard_normal((10, D)) * 3.0
    x = cl[rng.integers(0, 10, n)] + 0.4 * rng.standard_normal((n, D))
    y = np.sin(2 * x[:, 0]) * np.tanh(x[:, 1]) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32), y.astype(np.float32), cl


def trace(cl: np.ndarray, requests: int, seed: int = 0) -> list[np.ndarray]:
    """``requests`` host requests of 1-64 rows from the same distribution."""
    rng = np.random.default_rng(seed + 2)
    sizes = rng.integers(1, 65, requests)
    return [(cl[i % 10] + 0.4 * rng.standard_normal((r, D))).astype(np.float32)
            for i, r in enumerate(sizes)]


def fitted(x, y, device: str, backend: str | None = None, seed: int = 1) -> FalkonRegressor:
    """FALKON-BLESS fit once (BLESS lam 1e-3, at most 400 centers; lam 1e-5,
    20 CG iterations)."""
    kern = make_kernel("gaussian", sigma=2.0)
    est = FalkonRegressor(kernel=kern, sampler=BlessSampler(lam=1e-3, m_cap=400),
                          config=FitConfig(lam=1e-5, iters=20, backend=backend, device=device))
    return est.fit(x, y, key=seed)


def serve(server: KrrServer, reqs: list[np.ndarray]) -> tuple[list[torch.Tensor], float]:
    """Every request through ``server`` in one flush: (the answers in
    request order, seconds, the device synchronised)."""
    t0 = time.perf_counter()
    rids = [server.submit(q) for q in reqs]
    preds = server.flush()
    out = [preds[r] for r in rids]
    if out and out[-1].is_cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--backend", choices=["auto", "torch", "cuda", "sharded", "stream"],
                    default="auto", help="kernel-operator backend override")
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and the trace")
    ap.add_argument("--device", default="cuda", help="cuda (the card; the default) or cpu")
    args = ap.parse_args(argv)
    backend = None if args.backend == "auto" else args.backend
    dev = require_cuda_device(args.device)  # raises without a card: no fallback

    x_np, y_np, cl = clustered(args.n, args.seed)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    t0 = time.perf_counter()
    est = fitted(x, y, args.device, backend, seed=args.seed + 1)
    model = est.model_
    print(f"FALKON-BLESS fit: M = {model.centers.shape[0]} centers in "
          f"{time.perf_counter() - t0:.1f}s (backend={type(model.backend).__name__})")

    server = KrrServer(est, backend=backend, max_wave=2048, min_bucket=64)
    reqs = trace(cl, args.requests, args.seed)
    serve(server, reqs)  # warm-up: the trace once, so the timed run finds every bucket warm
    server.reset()  # zero the stats for the timed run
    preds, dt = serve(server, reqs)

    s = server.stats
    print(f"{s['requests']} requests / {s['rows']} rows in {dt * 1e3:.1f} ms "
          f"({s['rows'] / dt:.0f} rows/s)")
    print(f"{s['dispatches']} batched dispatches (vs {s['requests']} one per request), "
          f"buckets {sorted(s['buckets'])}, padding overhead "
          f"{s['padded_rows'] / max(1, s['rows']):.1%}")
    # every answer against the unbatched path
    err = max(float(torch.max(torch.abs(p - model.predict(torch.from_numpy(q).to(dev)))))
              for p, q in zip(preds, reqs))
    print(f"batched vs direct max abs diff: {err:.2e}")
    return {"m": int(model.centers.shape[0]), "requests": s["requests"], "rows": s["rows"],
            "dispatches": s["dispatches"], "seconds": dt, "rows_per_s": s["rows"] / dt,
            "max_abs_diff": err}


if __name__ == "__main__":
    main()
