"""Production training launcher.

    python -m repro_torch.launch.train --arch mamba2-370m --steps 200 \\
        --ckpt-dir /ckpt/run1 [--smoke] [--mesh local|single|multi] [--device cuda|cpu]

The port of ``repro.launch.train``, on the card unless ``--device cpu``:
``SyntheticLM`` batches, ``make_train_step`` under ``FaultTolerantLoop``
with ``AsyncCheckpointer`` checkpoints every ``--ckpt-every`` steps, a
restore from ``latest_step`` at start (through host memory into the state,
so no second copy of it lands on the card), minicpm's WSD schedule by
default, ``HeartbeatMonitor`` and a final ``done: ... tok/s, median step
..., stragglers`` line. The loop is deterministic-resumable: the state
restores from the latest checkpoint and the data pipeline replays by step
index, so a run killed after a checkpoint and relaunched ends in the same
bits as one that ran through.

``--mesh local`` runs on a world of one. ``single`` and ``multi`` build the
production meshes (256 and 512 ranks; a ValueError without them) and then
raise: executing the LM sharded across ranks is not ported (ROADMAP A), and
the launcher never trains replicated under a production mesh's name.

The reference ``jax.jit``s the step with the state donated. The port's step
updates the state in place (``optim.adamw``), so donation has no
counterpart. Each logged step also gives its kernel launches (counts reset
before the step: K9 in every Mamba layer, K8 in every attention layer, twice
under remat); on the card the run ends with its peak device memory.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..checkpoint.ckpt import _leaves, _rebuild
from ..configs import get_config, list_archs, smoke
from ..data import SyntheticLM
from ..optim import OptConfig
from ..runtime import FaultTolerantLoop, HeartbeatMonitor
from ..sharding.rules import MeshCtx, mesh_size, set_mesh_ctx
from ..training import TrainState, copy_state_, make_train_step, train_state_init
from .mesh import make_local_mesh, make_production_mesh

log = logging.getLogger("repro_torch.train")


def _restore(ckpt_dir: str, state: TrainState) -> tuple[int, TrainState]:
    """The latest checkpoint copied into ``state`` in place (read into host
    memory first); (its step, state)."""
    template = _rebuild(state, iter([0] * len(_leaves(state))))
    step, host = restore_checkpoint(ckpt_dir, template)
    return step, copy_state_(state, host)


def main(argv=None) -> None:
    from .. import kernels

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", choices=["local", "single", "multi"], default="local")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--loss-chunks", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    # minicpm ships with WSD (arXiv:2404.06395); others default cosine
    schedule = args.schedule or ("wsd" if args.arch.startswith("minicpm") else "cosine")
    opt_cfg = OptConfig(peak_lr=args.lr, warmup=max(5, args.steps // 20),
                        total_steps=args.steps, schedule=schedule)
    on_card = torch.device(args.device).type == "cuda"

    mesh = {"local": lambda: make_local_mesh(("data", "model"),
                                             device_type=torch.device(args.device).type),
            "single": lambda: make_production_mesh(multi_pod=False),
            "multi": lambda: make_production_mesh(multi_pod=True)}[args.mesh]()
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: training the LM sharded across {mesh_size(mesh)} ranks is not "
            "ported yet (ROADMAP A)")
    set_mesh_ctx(MeshCtx(mesh=mesh))
    try:
        pipe = SyntheticLM(cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0,
                           device=args.device)
        step = make_train_step(cfg, opt_cfg, loss_chunks=args.loss_chunks)
        state = train_state_init(cfg, seed=0, device=args.device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        start = 0
        ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
        if ckpt and latest_step(args.ckpt_dir) is not None:
            t0 = time.perf_counter()
            start, state = _restore(args.ckpt_dir, state)
            log.info("restored checkpoint at step %d in %.3fs", start,
                     time.perf_counter() - t0)

        log.info("ready to step in %.1fs (state built%s)", time.perf_counter() - t_start,
                 " and restored" if start else "")
        monitor = HeartbeatMonitor()

        def step_fn(st, i):
            kernels.reset_launch_counts()
            st, m = step(st, pipe.batch_at(i))
            if on_card:
                torch.cuda.synchronize()  # the monitor times the step, not its enqueue
            if (i + 1) % args.log_every == 0:
                launches = {k: v for k, v in kernels.launch_counts().items() if v}
                log.info("step %d loss %.4f lr %.2e gnorm %.3f launches %s", i + 1,
                         float(m["loss"]), float(m["lr"]), float(m["grad_norm"]),
                         json.dumps(launches))
            return st, m

        t0 = time.time()
        if ckpt:
            def restore():
                return _restore(args.ckpt_dir, state)

            loop = FaultTolerantLoop(step_fn, ckpt, ckpt_every=args.ckpt_every,
                                     monitor=monitor)
            state, _ = loop.run(state, start, args.steps - start, restore)
        else:
            for i in range(start, args.steps):
                t1 = time.perf_counter()
                state, _ = step_fn(state, i)
                monitor.record(i, time.perf_counter() - t1)
        dt = time.time() - t0
        tokens = (args.steps - start) * args.batch * args.seq
        if ckpt:
            log.info("checkpoints: %s", json.dumps(ckpt.timings))
        if on_card:
            log.info("peak device memory: %d B", torch.cuda.max_memory_allocated())
        log.info("done: %.1fs, %.0f tok/s, median step %.3fs, %d stragglers",
                 dt, tokens / max(dt, 1e-9), monitor.median, len(monitor.stragglers))
    finally:
        set_mesh_ctx(None)


if __name__ == "__main__":
    main()
