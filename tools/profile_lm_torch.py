#!/usr/bin/env python3
"""Where the port's LM serving time goes on the card: a torch.profiler trace
of one warm prefill and of a few warm decode steps.

    python3 tools/profile_lm_torch.py [--layers 8] [--batch 4] [--prompt 2048]
                                      [--slots 4] [--steps 8] [--seed 0]

Builds jamba-v0.1-52b at full width cut to ``--layers`` layers in bf16 with
random weights from ``--seed`` (chip_smoke.py phase 11's model), runs one
``prefill_logits`` on ``--batch`` x ``--prompt`` tokens and ``--steps``
``decode_step`` calls on ``--slots`` slots, each once to warm up and once
under the profiler. For each it prints one JSON line: wall ms (host clock
around work that ends in a synchronize), device ms (the sum of the CUDA
kernels' self time), the device's idle share (1 - device / wall), and the
kernels that take the most device time, grouped by name. Needs one CUDA
card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def _profile(fn, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "idle_share": 1.0 - dev_us / 1e3 / (wall * 1e3),
            "top": [{"name": e.key[:90], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_torch: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving import prefill_logits

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=args.layers)
    lm = LM(cfg, seed=args.seed)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), generator=g,
                           device="cuda")
    res = _profile(lambda: prefill_logits(lm, {"tokens": tokens}), args.top)
    print(json.dumps({"phase": "prefill", "batch": args.batch, "prompt": args.prompt,
                      "device": torch.cuda.get_device_name(0), **res}), flush=True)
    cache = lm.init_cache(args.slots, args.steps * 2 + 2)
    tok = torch.randint(0, cfg.vocab_size, (args.slots,), generator=g, device="cuda")
    pos = [0]

    def decode():
        for _ in range(args.steps):
            lm.decode_step(cache, tok, pos[0], length=pos[0] + 1)
            pos[0] += 1

    res = _profile(decode, args.top)
    print(json.dumps({"phase": "decode", "slots": args.slots, "steps": args.steps,
                      "ms_per_step": res["wall_ms"] / args.steps,
                      "device": torch.cuda.get_device_name(0), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
