"""Production training launcher.

    python -m repro_torch.launch.train --arch mamba2-370m --steps 200 \\
        --ckpt-dir /ckpt/run1 [--smoke] [--mesh local|single|multi] [--device cuda|cpu] \\
        [--seed 0]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch mamba2-370m ...

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

Under ``torchrun`` the group comes from its environment (``launch.mesh``:
NCCL when each rank has a card, gloo when ranks share one or on the CPU).
``--mesh local`` puts every rank on ``data`` (the reference's
``make_local_mesh``); ``single`` and ``multi`` build the production meshes
(256 and 512 ranks; a ValueError naming the group's size without them).
On a mesh of more than one rank the step runs sharded
(``sharding.collectives``): the state is each rank's blocks under
``param_specs`` (``models.init_blocks``: the seed's model drawn one leaf
at a time, each cut to its block before the next), each rank draws
its rows of the global ``--batch``, ``ShardedCheckpointer`` gathers the
checkpoints to rank 0 in the one-rank format, and a restart reads each
rank's blocks (``restore_checkpoint(specs=, mesh=)``). A failed step there
is not retried: the other ranks cannot replay it, so it raises. Rank 0
logs; its step lines add every rank's kernel launches, and the run ends
with each rank's state bytes and peak device memory (while its params
are drawn, and after).

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
import torch.distributed as dist

from ..checkpoint import AsyncCheckpointer, ShardedCheckpointer, latest_step, restore_checkpoint
from ..checkpoint.ckpt import _leaves, _rebuild
from ..configs import get_config, list_archs, smoke
from ..data import SyntheticLM
from ..models import init_blocks, param_specs
from ..optim import OptConfig, adamw_init, opt_state_specs
from ..runtime import FaultTolerantLoop, HeartbeatMonitor
from ..sharding import collectives as tp
from ..sharding.rules import MeshCtx, set_mesh_ctx
from ..training import TrainState, copy_state_, make_train_step, train_state_init
from .dryrun import tree_bytes
from .mesh import init_from_env, make_local_mesh, make_production_mesh

log = logging.getLogger("repro_torch.train")


def _restore(ckpt_dir: str, state: TrainState, specs=None, mesh=None) -> tuple[int, TrainState]:
    """The latest checkpoint copied into ``state`` in place (read into host
    memory first; with ``specs`` and ``mesh``, each rank's blocks); (its
    step, state)."""
    template = _rebuild(state, iter([0] * len(_leaves(state))))
    step, host = restore_checkpoint(ckpt_dir, template, specs=specs, mesh=mesh)
    return step, copy_state_(state, host)


def main(argv=None) -> list[tuple[int, float]]:
    """Train as the flags say; returns the logged steps' (step, loss), the
    steps this run took (a relaunch's from its restored step)."""
    from .. import kernels

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", choices=["local", "single", "multi"], default="local")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch rows")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--loss-chunks", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the data")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    # minicpm ships with WSD (arXiv:2404.06395); others default cosine
    schedule = args.schedule or ("wsd" if args.arch.startswith("minicpm") else "cosine")
    opt_cfg = OptConfig(peak_lr=args.lr, warmup=max(5, args.steps // 20),
                        total_steps=args.steps, schedule=schedule)
    device_type = torch.device(args.device).type
    on_card = device_type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launcher runs on the card unless given "
                           "--device cpu")
    owns_group = not dist.is_initialized() and init_from_env(device_type)

    try:
        mesh = {"local": lambda: make_local_mesh(("data", "model"), device_type=device_type),
                "single": lambda: make_production_mesh(multi_pod=False, device_type=device_type),
                "multi": lambda: make_production_mesh(multi_pod=True,
                                                      device_type=device_type)}[args.mesh]()
        ctx = MeshCtx(mesh=mesh)
        set_mesh_ctx(ctx)
        plan = tp.active()
        rank = dist.get_rank() if plan is not None else 0
        if rank:
            log.setLevel(logging.WARNING)
        shard = (plan.batch_index, plan.batch_ways) if plan is not None else (0, 1)
        pipe = SyntheticLM(cfg.vocab_size, batch=args.batch, seq=args.seq, seed=args.seed,
                           device=args.device, shard=shard)
        step = make_train_step(cfg, opt_cfg, loss_chunks=args.loss_chunks)
        specs = init_peak = None
        if plan is None:
            state = train_state_init(cfg, seed=args.seed, device=args.device)
        else:
            pspecs = param_specs(cfg, ctx)
            specs = TrainState(pspecs, opt_state_specs(pspecs))
            params = init_blocks(cfg, pspecs, mesh, seed=args.seed, device=args.device)
            init_peak = torch.cuda.max_memory_allocated() if on_card else None
            for p in params.values():
                p.requires_grad_(True)
            state = TrainState(params, adamw_init(params))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        start = 0
        ckpt = None
        if args.ckpt_dir:
            ckpt = (AsyncCheckpointer(args.ckpt_dir) if plan is None else
                    ShardedCheckpointer(args.ckpt_dir, specs,
                                        train_state_init(cfg, device="meta"), mesh))
        if ckpt and latest_step(args.ckpt_dir) is not None:
            t0 = time.perf_counter()
            start, state = _restore(args.ckpt_dir, state, specs, mesh)
            log.info("restored checkpoint at step %d in %.3fs", start,
                     time.perf_counter() - t0)

        log.info("ready to step in %.1fs (state built%s)", time.perf_counter() - t_start,
                 " and restored" if start else "")
        monitor = HeartbeatMonitor()
        logged: list[tuple[int, float]] = []

        def step_fn(st, i):
            kernels.reset_launch_counts()
            st, m = step(st, pipe.batch_at(i))
            if on_card:
                torch.cuda.synchronize()  # the monitor times the step, not its enqueue
            if (i + 1) % args.log_every == 0:
                launches = {k: v for k, v in kernels.launch_counts().items() if v}
                logged.append((i + 1, float(m["loss"])))
                log.info("step %d loss %.4f lr %.2e gnorm %.3f launches %s", i + 1,
                         logged[-1][1], float(m["lr"]), float(m["grad_norm"]),
                         json.dumps(launches))
                if plan is not None:
                    ranks = [None] * dist.get_world_size()
                    dist.all_gather_object(ranks, launches)
                    log.info("step %d rank launches %s", i + 1, json.dumps(ranks))
            return st, m

        t0 = time.time()
        if ckpt:
            def restore():
                return _restore(args.ckpt_dir, state, specs, mesh)

            # a rank's failed step cannot be replayed without the others: raise
            loop = FaultTolerantLoop(step_fn, ckpt, ckpt_every=args.ckpt_every,
                                     monitor=monitor, max_restarts=3 if plan is None else 0)
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
        if plan is not None:
            mine = {"state_bytes": tree_bytes(state.params) + tree_bytes(state.opt),
                    "init_peak_bytes": init_peak,
                    "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None}
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
            log.info("per-rank: %s", json.dumps(ranks))
        log.info("done: %.1fs, %.0f tok/s, median step %.3fs, %d stragglers",
                 dt, tokens / max(dt, 1e-9), monitor.median, len(monitor.stragglers))
        return logged
    finally:
        set_mesh_ctx(None)
        if owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
