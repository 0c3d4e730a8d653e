"""Meta-device stand-ins for every (arch x shape) dry-run cell.

The port of ``repro.launch.specs``. ``input_specs(cfg, shape_name, ctx)``
returns (fn, args): fn is the cell's step, args are meta tensors (no
memory) of one rank's shard shapes under the ctx's mesh (``local_shape`` of
each spec; a ``MeshShape`` for the production meshes). The reference also
returns the donated arguments; the port's steps update the state and the
decode cache in place, so there is no donation to name.

The shard shapes size each rank's memory. The step runs on a mesh's
ranks as they are (each tensor its rank's block, ``sharding.collectives``);
on the meta device it runs the args of a mesh of one rank. The decode
cells take ``sharding.serve_ctx``'s layout, the one ``LM.init_cache``
allocates under a serving mesh.

Shape set (assigned):
  train_4k     seq 4096,  global_batch 256  -> train_step
  prefill_32k  seq 32768, global_batch 32   -> prefill_logits (serve)
  decode_32k   seq 32768 KV, batch 128      -> decode_step    (serve)
  long_500k    seq 524288 KV, batch 1       -> decode_step    (serve, SP)

Skips: long_500k for pure full-attention archs; decode shapes for
encoder-only archs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..models import LM, cache_specs, param_specs
from ..models.config import TP, ArchConfig
from ..models.model import model_dtype
from ..optim import OptConfig, opt_state_specs
from ..serving.engine import prefill_logits
from ..sharding.rules import MeshCtx, local_shape, logical_to_spec, serve_ctx
from ..training import TrainState, make_train_step

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

FULL_ATTENTION_FAMILIES = ("dense", "moe", "vlm")  # no sub-quadratic path


def cell_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    info = SHAPES[shape_name]
    if info["kind"] == "decode" and not cfg.has_decode:
        return False, "encoder-only arch: no decode step"
    if shape_name == "long_500k" and cfg.family in FULL_ATTENTION_FAMILIES \
            and cfg.attention_impl != "bless_nystrom":
        return False, "full-attention arch: 500k KV needs sub-quadratic attention"
    return True, ""


def _shard(shape, spec, dtype, ctx: MeshCtx) -> torch.Tensor:
    """A meta tensor of one rank's shard of ``shape`` under ``spec`` (the
    whole shape without a mesh)."""
    if ctx.mesh is not None:
        shape = local_shape(shape, spec, ctx.mesh)
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta(shape, dtype, ctx: MeshCtx, *logical) -> torch.Tensor:
    return _shard(shape, logical_to_spec(*logical, ctx=ctx), dtype, ctx)


def _sharded(tensors: dict[str, torch.Tensor], specs: dict, ctx: MeshCtx,
             dtype: Optional[torch.dtype] = None) -> dict[str, torch.Tensor]:
    """Meta tensors of each tensor's shard under its spec (in ``dtype`` if
    given, else its own)."""
    return {k: _shard(t.shape, specs[k], dtype or t.dtype, ctx) for k, t in tensors.items()}


def batch_specs(cfg: ArchConfig, b: int, s: int, ctx: MeshCtx) -> dict:
    """Input batch meta tensors for a full forward/train step."""
    bat: dict[str, Any] = {}
    if cfg.embed_inputs:
        bat["tokens"] = _meta((b, s), torch.int64, ctx, "batch", None)
    else:
        bat["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16, ctx, "batch", None, None)
    bat["labels"] = _meta((b, s), torch.int64, ctx, "batch", None)
    if cfg.pos == "mrope":
        bat["mrope_positions"] = _meta((b, 3, s), torch.int64, ctx, "batch", None, None)
    if cfg.extra_image_tokens:
        bat["pixel_embeds"] = _meta((b, cfg.extra_image_tokens, cfg.d_model), torch.bfloat16,
                                    ctx, "batch", None, None)
    return bat


def _shapes(cfg: ArchConfig) -> dict[str, torch.Tensor]:
    return LM(cfg, device="meta").state_dict()


def params_sds(cfg: ArchConfig, ctx: MeshCtx) -> dict[str, torch.Tensor]:
    return _sharded(_shapes(cfg), param_specs(cfg, ctx), ctx)


def train_specs(cfg: ArchConfig, b: int, s: int, ctx: MeshCtx, *,
                opt_cfg: Optional[OptConfig] = None, loss_chunks: int = 32,
                microbatches: int = 1, zero: int = 3) -> tuple[Callable, tuple]:
    """(train_step, (TrainState, batch)) of a B x S train step.

    ZeRO-3 (default): params fsdp+tp sharded. ZeRO-1: params tp-only
    (replicated over data), optimizer state fsdp+tp sharded."""
    p_ctx = dataclasses.replace(ctx, fsdp=False) if zero == 1 else ctx
    shapes = _shapes(cfg)
    params = _sharded(shapes, param_specs(cfg, p_ctx), p_ctx)
    ospecs = opt_state_specs(param_specs(cfg, ctx))
    # the step lies on the host, as ``adamw_init`` keeps it (the schedule reads it there)
    opt = {"step": torch.zeros((), dtype=torch.int64),
           **{k: _sharded(shapes, ospecs[k], ctx, torch.float32) for k in ("master", "mu", "nu")}}
    fn = make_train_step(cfg, opt_cfg or OptConfig(), loss_chunks=loss_chunks,
                         microbatches=microbatches)
    return fn, (TrainState(params=params, opt=opt), batch_specs(cfg, b, s, ctx))


class _Serve(nn.Module):
    """``prefill_logits`` and ``decode_step`` of a weightless LM, for
    ``torch.func.functional_call`` on a params dict."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.lm = LM(cfg, device="meta")

    def forward(self, kind: str, *args, **kwargs):
        if kind == "prefill":
            return prefill_logits(self.lm, *args)
        return self.lm.decode_step(*args, **kwargs)


def input_specs(cfg: ArchConfig, shape_name: str, ctx: MeshCtx,
                opt_cfg: Optional[OptConfig] = None,
                loss_chunks: int = 32,
                kv_len: Optional[int] = None,
                microbatches: int = 1,
                zero: int = 3) -> tuple[Callable, tuple]:
    """(step_fn, arg meta tensors) for one cell.

    kv_len: decode-cache length override, the BLESS leverage-score KV
    compression serving mode (``models.attention.bless_compress_cache`` keeps
    the top-M RLS keys; the decode step then runs against an M-entry
    cache)."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    if kv_len is not None and info["kind"] == "decode":
        s = kv_len
    kind = info["kind"]
    if kind == "train":
        return train_specs(cfg, b, s, ctx, opt_cfg=opt_cfg, loss_chunks=loss_chunks,
                           microbatches=microbatches, zero=zero)

    serve = _Serve(cfg)

    def call(params, *args, **kwargs):
        return torch.func.functional_call(serve, {f"lm.{k}": v for k, v in params.items()},
                                          args, kwargs)

    if kind == "prefill":
        pctx = dataclasses.replace(ctx, fsdp=False)
        bat = batch_specs(cfg, b, s, pctx)
        bat.pop("labels")
        return (lambda params, batch: call(params, "prefill", batch)), \
            (params_sds(cfg, pctx), bat)

    # decode: batch over (pod,data); KV seq over model (decode_32k) or over
    # data+model (long_500k, batch=1: SP across every rank)
    dctx = serve_ctx(ctx.mesh, b, rules=ctx.rules)
    cache = cache_sds(cfg, b, s, ctx)
    tok = _meta((b,), torch.int64, dctx, "batch")
    pos = torch.empty((), dtype=torch.int64, device="meta")
    p_sds = params_sds(cfg, dctx)
    if cfg.pos == "mrope":
        mp = _meta((b, 3, 1), torch.int64, dctx, "batch", None, None)

        def fn(params, cache, token, pos, mrope_pos):
            return call(params, "decode", cache, token, pos, mrope_pos=mrope_pos)

        return fn, (p_sds, cache, tok, pos, mp)

    def fn(params, cache, token, pos):
        return call(params, "decode", cache, token, pos)

    return fn, (p_sds, cache, tok, pos)


def cache_sds(cfg: ArchConfig, b: int, s: int, ctx: MeshCtx) -> list[dict[str, torch.Tensor]]:
    """``LM.init_cache(b, s)``'s layout as meta tensors of one rank's blocks
    under the serve layout of a batch of ``b`` on ``ctx``'s mesh and rules
    (``serve_ctx``): what ``init_cache`` allocates on each rank there."""
    dtype = model_dtype(cfg)
    ctx = serve_ctx(ctx.mesh, b, rules=ctx.rules)
    specs = cache_specs(cfg, ctx, seq_logical=ctx.kv_seq)
    out = []
    for i, spec in enumerate(specs):
        if cfg.mixer_kind(i) == "attn":
            shape = (b, s, cfg.padded_kv_heads(TP), cfg.head_dim)
            layer = {"k": (shape, dtype), "v": (shape, dtype)}
        else:
            layer = {"conv": ((b, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state), dtype),
                     "state": ((b, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                               torch.float32)}
        out.append({k: _shard(shape, spec[k], dt, ctx) for k, (shape, dt) in layer.items()})
    return out
