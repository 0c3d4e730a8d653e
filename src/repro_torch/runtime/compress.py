"""Gradient compression for the slow all-reduce, over ``torch.distributed``.

The port of ``repro.runtime.compress``. Two levels:
  * bf16 all-reduce: cast, sum, cast back (2x fewer bytes than fp32);
  * int8 with error feedback: per-tensor symmetric quantisation, the
    residual carried to the next step (1-bit-Adam-style EF), 4x fewer.

The reference reduces over a ``shard_map`` axis; here over a process group
(``group``, default the world). Without an initialised group, or in a
world of one, no collective runs and each result is what a one-rank
reduction gives: the compressed tensor decompressed (the bf16 rounding, or
the int8 round trip), as the reference's psum over an axis of one.

The int8 reduction gathers every rank's int8 tensor and fp32 scale (the
wire format the reference describes) and sums the dequantised tensors in
rank order, so every rank gets the same bits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..checkpoint.ckpt import _leaves, _rebuild


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def _map(fn, tree, *rest):
    """``tree``'s structure with each leaf (with the matching leaves of
    ``rest``) passed through ``fn``."""
    cols = [[leaf for _, leaf in _leaves(t)] for t in (tree, *rest)]
    return _rebuild(tree, iter([fn(*args) for args in zip(*cols, strict=True)]))


def compressed_psum_bf16(tree, group=None):
    """Every tensor of ``tree`` (dicts, lists, tuples) summed over the group
    in bf16 and cast back to its dtype."""
    def one(g: torch.Tensor) -> torch.Tensor:
        h = g.to(torch.bfloat16)
        if _world(group) > 1:
            dist.all_reduce(h, group=group)
        return h.to(g.dtype)

    return _map(one, tree)


def int8_compress(g: torch.Tensor,
                  err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + carried error -> (q int8, scale 0-d fp32, new error fp32)."""
    gf = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_state_init(grads):
    """Zero fp32 error-feedback residuals shaped as ``grads``."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_allreduce_int8(tree, ef, group=None):
    """Error-feedback int8 all-reduce of every tensor of ``tree`` with its
    residual in ``ef``: (the sums in each tensor's dtype, the new residuals)."""
    world = _world(group)
    residuals = []

    def one(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        q, scale, new_e = int8_compress(g, e)
        residuals.append(new_e)
        if world == 1:
            return int8_decompress(q, scale).to(g.dtype)
        qs = [torch.empty_like(q) for _ in range(world)]
        scales = [torch.empty_like(scale) for _ in range(world)]
        dist.all_gather(qs, q, group=group)
        dist.all_gather(scales, scale, group=group)
        total = int8_decompress(qs[0], scales[0])
        for qr, sr in zip(qs[1:], scales[1:]):
            total = total + int8_decompress(qr, sr)
        return total.to(g.dtype)

    out = _map(one, tree, ef)
    return out, _rebuild(ef, iter(residuals))
