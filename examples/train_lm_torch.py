"""Train an assigned-architecture LM end to end on the PyTorch / H100 port
(fault-tolerant loop, async checkpoints, deterministic resumable data).

A thin wrapper over the port's launcher (``repro_torch.launch.train``);
smoke-scale by default, the full configs behind --no-smoke:

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-32b --steps 60
    PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-370m \\
        --steps 300 --no-smoke     # ~370M-parameter model, real shapes
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 8

The counterpart of ``examples/train_lm.py``: on the card unless given
``--device cpu`` (the launcher raises without a card); the weights and the
batches come from ``--seed``. A run resumes from the newest checkpoint in
``--ckpt-dir``. Returns the logged (step, loss) pairs.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as launch_main


def main(argv=None) -> list[tuple[int, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--no-smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "lm_ckpt"))
    ap.add_argument("--log-every", type=int, default=10, help="steps between loss lines")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the data")
    ap.add_argument("--device", default="cuda", help="cuda (the card; the default) or cpu")
    args = ap.parse_args(argv)

    launch = ["--arch", args.arch, "--steps", str(args.steps), "--ckpt-dir", args.ckpt_dir,
              "--ckpt-every", "25", "--log-every", str(args.log_every), "--seed", str(args.seed),
              "--device", args.device]
    if not args.no_smoke:
        launch.append("--smoke")
    return launch_main(launch)


if __name__ == "__main__":
    main()
