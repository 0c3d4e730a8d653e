"""Dry run of every (arch x input-shape x mesh) cell on the meta device.

The port of ``repro.launch.dryrun``. For each cell it sizes one rank's
state from the specs under the production mesh's ``MeshShape`` (params,
optimizer state, decode cache and batch: ``local_shape`` of each spec),
takes the FLOPs and HBM bytes from ``cost_model.step_costs`` (the
reference's padded heads, which the port's models compute), cross-checks the analytic FLOPs on a
small configuration of the arch with ``flop_count`` on the meta device, and
gives a ``Roofline`` row on the H100's peaks. Nothing touches a card and
nothing is allocated.

The reference lowers and compiles each cell for 512 placeholder devices
and reads memory, FLOPs and collective bytes from the compiled program.
PyTorch compiles no whole-program SPMD step, so: the per-rank memory is the
state the specs place on a rank (activations and temporaries not counted);
collective bytes cannot be measured without the ranks, and the row gives
them as null with a note, never 0. Results are cached as JSON, one file per
cell, under ``--out``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all            # every supported cell
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any

import torch

from ..configs import get_config, list_archs, smoke
from ..models.model import padded_vocab
from ..sharding.rules import MeshCtx
from . import cost_model
from .mesh import production_mesh_shape
from .roofline import Roofline
from .specs import SHAPES, batch_specs, cell_supported, input_specs

COLL_NOTE = "not measured: no process group"
#: the small configuration of the FLOP cross-check: one period of the arch's
#: smoke config, remat off, B x S tokens (tests/test_roofline.py's).
CHECK_BATCH, CHECK_SEQ = 2, 64


def model_flops(cfg, shape_name: str) -> float:
    info = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n_active * tokens
    if info["kind"] == "prefill":
        return 2.0 * n_active * info["batch"] * info["seq"]
    return 2.0 * n_active * info["batch"]  # decode: one token per sequence


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` (dicts, lists, tuples, NamedTuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(t) for t in tree)
    return 0


def state_bytes(args: tuple, kind: str) -> dict[str, int]:
    """One rank's bytes of a cell's args by part: params, opt, cache, batch."""
    if kind == "train":
        state, batch = args
        return {"params": tree_bytes(state.params), "opt": tree_bytes(state.opt),
                "cache": 0, "batch": tree_bytes(batch)}
    if kind == "prefill":
        return {"params": tree_bytes(args[0]), "opt": 0, "cache": 0,
                "batch": tree_bytes(args[1])}
    return {"params": tree_bytes(args[0]), "opt": 0, "cache": tree_bytes(args[1]),
            "batch": tree_bytes(args[2:])}


def flop_check(cfg) -> dict:
    """``flop_count`` of one forward of a small configuration of ``cfg`` on
    the meta device against ``cost_model.forward_flops``, without the
    logits (the forward ends at the final norm)."""
    from ..models import LM

    small = dataclasses.replace(smoke(cfg), n_layers=smoke(cfg).layer_period, remat=False,
                                attn_chunk=64)
    lm = LM(small, device="meta")
    bat = batch_specs(small, CHECK_BATCH, CHECK_SEQ, MeshCtx())
    bat.pop("labels")
    counted = cost_model.flop_count(lm, bat)["flops"]
    tokens = CHECK_BATCH * CHECK_SEQ
    analytic = (cost_model.forward_flops(small, CHECK_BATCH, CHECK_SEQ).flops_fwd
                - 2 * tokens * small.d_model * padded_vocab(small))
    return {"config": f"{small.name}, {small.n_layers} layers, B {CHECK_BATCH}, S {CHECK_SEQ}",
            "counted": counted, "analytic": analytic,
            "ratio": analytic / counted if counted else None}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             attention_impl: str | None = None,
             moe_sharding: str | None = None,
             kv_len: int | None = None,
             microbatches: int = 1,
             zero: int = 3) -> dict:
    cfg = get_config(arch)
    if attention_impl:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    if moe_sharding:
        cfg = dataclasses.replace(cfg, moe_sharding=moe_sharding)
    ok, why = cell_supported(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = production_mesh_shape(multi_pod=multi_pod)
    ctx = MeshCtx(mesh=mesh)
    try:
        info = SHAPES[shape_name]
        t0 = time.time()
        _, args = input_specs(cfg, shape_name, ctx, kv_len=kv_len,
                              microbatches=microbatches, zero=zero)
        by_part = state_bytes(args, info["kind"])
        t_specs = time.time() - t0
        mem = sum(by_part.values())
        print(f"[{arch} x {shape_name} x {mesh_name}] per-rank state: "
              + " ".join(f"{k}={v / 2**30:.2f}GiB" for k, v in by_part.items())
              + " (activations and temporaries not counted)")
        chips = mesh.size
        s_kv = (kv_len or info["seq"]) if info["kind"] == "decode" else None
        ana = cost_model.step_costs(
            cfg, info["kind"], info["batch"], 1 if info["kind"] == "decode" else info["seq"],
            chips, s_kv=s_kv)
        check = flop_check(cfg)
        roof = Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            flops_per_device=ana["flops_per_device"],
            bytes_per_device=ana["hbm_bytes_per_device"],
            coll_bytes_per_device=None, coll_breakdown=None,
            peak_memory_per_device=float(mem),
            model_flops=model_flops(cfg, shape_name))
        row = roof.row()
        row.update(status="ok", specs_s=round(t_specs, 1),
                   attention_impl=cfg.attention_impl,
                   coll_bytes=COLL_NOTE,
                   bytes_per_rank={**by_part, "total": mem},
                   mem_args_gb=round(mem / 2**30, 3),
                   mem_temps_gb=None,
                   flops_check=check,
                   flops_breakdown={k: v for k, v in ana["flops_breakdown"].items() if v})
        return row
    except Exception as e:  # noqa: BLE001 — report failures as data
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "failed", "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--attention-impl", choices=["full", "bless_nystrom"])
    ap.add_argument("--moe-sharding", choices=["auto", "ep", "tp", "replicate"])
    ap.add_argument("--kv-cache-len", type=int, default=None,
                    help="decode-cache override: BLESS-compressed KV serving")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--zero", type=int, choices=[1, 3], default=3)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="exp/dryrun_torch")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            if args.attention_impl:
                tag += f"__{args.attention_impl}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"cached: {tag}")
                continue
            row = run_cell(arch, shape, mp, attention_impl=args.attention_impl,
                           moe_sharding=args.moe_sharding, kv_len=args.kv_cache_len,
                           microbatches=args.microbatches, zero=args.zero)
            with open(path, "w") as f:
                json.dump(row, f, indent=1)
            print(f"{tag}: {row['status']} "
                  + (f"bottleneck={row.get('bottleneck')} "
                     f"roofline={row.get('roofline_fraction', 0):.3f}"
                     if row["status"] == "ok" else row.get("reason", row.get("error", ""))))


if __name__ == "__main__":
    main()
