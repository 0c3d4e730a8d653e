"""Serve a small model with batched requests (continuous batching) and
demonstrate BLESS leverage-score KV-cache compression on the PyTorch / H100
port -- the paper's technique as a serving feature.

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch jamba-v0.1-52b]
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The counterpart of ``examples/serve_batched.py``: a smoke config trained
briefly (the forward's attention through K8, Mamba layers through K9 on the
card), served by ``ServeEngine`` with a request joining mid-flight, then
``bless_compress_cache`` of one attention layer's cache. It runs on the
card unless given ``--device cpu`` and raises without a card; the weights,
the batches and the cache come from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_archs, smoke
from repro_torch.core.backend import require_cuda_device
from repro_torch.data import SyntheticLM
from repro_torch.models import LM
from repro_torch.models.attention import bless_compress_cache
from repro_torch.optim import OptConfig
from repro_torch.serving import ServeEngine
from repro_torch.training import make_train_step, train_state_init


def pretrain(cfg, device: str, *, steps: int = 40, seed: int = 0) -> tuple[LM, SyntheticLM, list]:
    """The seed's model trained ``steps`` steps on SyntheticLM batches, so
    generations follow the synthetic rule: (the model, its data, the
    losses). The state lends the model's own tensors, so the model serves
    the trained weights."""
    lm = LM(cfg, seed=seed, device=device)
    state = train_state_init(lm)
    step = make_train_step(cfg, OptConfig(peak_lr=3e-3, warmup=5, total_steps=steps),
                           loss_chunks=4)
    pipe = SyntheticLM(cfg.vocab_size, batch=8, seq=64, seed=seed, noise=0.05, device=device)
    losses = []
    for s in range(steps):
        state, m = step(state, pipe.batch_at(s))
        losses.append(float(m["loss"]))
    return lm, pipe, losses


def continuous_batching(lm: LM, pipe: SyntheticLM, device: str, *, n_steps: int = 12) -> dict:
    """Requests arriving at different times: slots 0 and 1 start, slot 2
    joins after 4 steps. {"outputs": each slot's tokens, "seconds"}."""
    eng = ServeEngine(lm, max_len=64, batch_slots=4, device=device)
    perm = pipe._rule()
    eng.add_request(0, [int(perm[7]), int(perm[perm[7]])])
    eng.add_request(1, [3, int(perm[3])])
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == 4:  # a request joins mid-flight
            eng.add_request(2, [11])
        eng.step()
    if lm.device.type == "cuda":
        torch.cuda.synchronize()
    return {"outputs": [eng.finish(slot) for slot in range(3)],
            "seconds": time.perf_counter() - t0, "steps": n_steps}


def compress(lm: LM, *, batch: int = 2, s_full: int = 64, m_keep: int = 16,
             seed: int = 0) -> dict | None:
    """BLESS KV compression of the first attention layer's cache (random
    keys and values from ``seed``): keep the top-RLS keys, decode against
    m << S. None for a model without attention."""
    cache = lm.init_cache(batch, s_full, dtype=torch.float32)
    layer = next((c for c in cache if "k" in c), None)
    if layer is None:
        return None
    g = torch.Generator(device=lm.device).manual_seed(seed + 1)
    k = torch.randn(layer["k"].shape, generator=g, device=lm.device)
    v = torch.randn(layer["v"].shape, generator=g, device=lm.device)
    kc, vc = bless_compress_cache(k, v, m=m_keep)
    return {"from": list(k.shape), "to": list(kc.shape), "ratio": s_full / m_keep,
            "finite": bool(torch.isfinite(kc).all() and torch.isfinite(vc).all())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-32b",
                    help="the architecture whose smoke config is served")
    ap.add_argument("--steps", type=int, default=40, help="training steps before serving")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the data")
    ap.add_argument("--device", default="cuda", help="cuda (the card; the default) or cpu")
    args = ap.parse_args(argv)
    require_cuda_device(args.device)  # raises without a card: no fallback

    cfg = smoke(get_config(args.arch))
    print(f"arch: {cfg.name} ({cfg.n_layers}L d={cfg.d_model})")
    lm, pipe, losses = pretrain(cfg, args.device, steps=args.steps, seed=args.seed)
    print(f"pre-trained {args.steps} steps, loss {losses[-1]:.3f}")

    served = continuous_batching(lm, pipe, args.device)
    for slot, toks in enumerate(served["outputs"]):
        print(f"slot {slot}: {toks}")
    print(f"{served['steps']} decode steps x active slots in {served['seconds']:.2f}s "
          f"({served['steps'] * 3 / served['seconds']:.1f} tok/s aggregate)")

    kv = compress(lm, seed=args.seed)
    if kv is not None:
        print(f"KV compression: {tuple(kv['from'])} -> {tuple(kv['to'])} "
              f"({kv['ratio']:.0f}x less KV traffic per decoded token)")
    return {"arch": cfg.name, "losses": losses, **served, "compress": kv}


if __name__ == "__main__":
    main()
