"""Model assembly: the LM stack for every configuration, forward and decode.

The port of the reference's ``repro.models.model`` on one card. ``LM`` holds
the embeddings, the final norm, the output head and one ``Block`` per layer
(a mixer, attention or Mamba-2, and an MLP, dense or MoE, each after an
RMSNorm, as ``ArchConfig`` lays them out). Where the reference stacks each
period position's parameters over groups and scans them, the port keeps a
flat ``layers`` list: layer ``g * period + j`` is the reference's
``blocks/blk{j}`` at group ``g`` (``repro_torch.interop`` unstacks them).

Attention has the reference's head layout on one card and on every mesh:
q heads padded to a multiple of its 16-way model axis
(``cfg.padded_heads(TP)``; under MHA the kv heads with them), the padded
heads multiplied by 0 before ``wo``, q head h reading kv head
``h // (padded q heads // kv heads)``. Where the padding changes that
grouping (granite-moe-3b-a800m's 24 / 8 heads, llama4-scout-17b-a16e's
40 / 8, qwen2-vl-2b's 12 / 2) this is the reference's regrouped model, not
the published one: the port keeps it for parity (ROADMAP C.2c). Every
``model`` axis that divides 16 splits the padded heads evenly.
``param_specs`` and ``cache_specs`` give the reference's partition specs by
the same leaf-name rules, keyed as ``LM.state_dict()`` and ``LM.init_cache``
are (no leading axis for the stacked layers: the port's are not stacked).

``LM.forward`` is differentiable (K8 and K9 carry ``autograd.Function``s):
under ``cfg.remat`` each layer is checkpointed when a gradient is taken, as
the reference's per-layer ``jax.checkpoint``. ``loss_fn`` is the
reference's chunked cross-entropy. Serving runs without a graph
(``decode_step`` and ``serving.prefill_logits`` under ``torch.no_grad``).

Under a ``DeviceMesh`` of more than one rank (``sharding.activate_mesh``)
the forward and ``loss_fn`` run sharded, each tensor the rank's block
(``sharding.collectives``): the batch rows over ``data``, every leaf
stored as its ``param_specs`` block and gathered over ``data`` where it is
used (FSDP), attention's padded q heads and Mamba-2 heads, MLP columns and
the vocabulary split over ``model`` (tensor parallelism; ``logits`` gives
the rank's vocabulary block), MoE layers in the reference's layout
(``cfg.moe_mode(TP)``: experts or each expert's ff columns over
``model``, or replicated). Decode runs under ``rules.serve_ctx``'s layouts:
the cache as ``cache_specs``' blocks (attention's sequence over ``model``,
or over every rank for one sequence; Mamba-2's channels and heads over
``model``), each rank attending over its block of the sequence and the
partials merged by log-sum-exp (``collectives.merge_attention``).

Decode caches are plain dicts, one per layer, updated in place by
``decode_step`` (the reference returns a new cache pytree).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..sharding import collectives as tp
from ..sharding import rules
from ..sharding.rules import (MeshCtx, PartitionSpec, local_shape, logical_to_spec,
                              under_mesh_ctx)
from . import layers
from .attention import (attention, decode_attention, decode_attention_partial,
                        nystrom_attention)
from .config import TP, ArchConfig
from .layers import (MLP, apply_mrope, apply_rope, lowp, ninit, param, rms_norm,
                     sinusoidal_pos)
from .mamba2 import Mamba
from .moe import MoE


def padded_vocab(cfg: ArchConfig) -> int:
    return (cfg.vocab_size + 127) // 128 * 128


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def head_share(cfg: ArchConfig, ways: int, rank: int) -> tuple[int, int, int, int]:
    """(q_lo, q_hi, kv_lo, kv_hi) of ``model`` rank ``rank`` of ``ways``:
    its contiguous share [q_lo, q_hi) of the padded q heads and the kv
    heads [kv_lo, kv_hi) they read (q head h reads kv head
    ``h // (padded q heads // padded kv heads)``), each of those kv heads
    serving an equal run of the share, as the attention kernels group
    heads. Raises NotImplementedError where the padded q heads do not divide
    over ``ways`` or a share straddles kv heads unevenly; neither happens
    for a configuration of the repo on an axis that divides 16."""
    hp, kvp = cfg.padded_heads(TP), cfg.padded_kv_heads(TP)
    hq, group = hp // ways, hp // kvp
    q_lo = rank * hq
    kv_lo, kv_hi = q_lo // group, (q_lo + hq - 1) // group + 1
    if hp % ways or (hq % group and group % hq):
        raise NotImplementedError(f"{hp} padded q heads over {kvp} kv heads do not split "
                                  f"evenly over a model axis of {ways}")
    return q_lo, q_lo + hq, kv_lo, kv_hi


class Attention(nn.Module):
    """q/k/v projections, optional qk-norm, rotary positions, exact attention
    (K8 on the card) or, with ``attention_impl="bless_nystrom"`` past
    ``nystrom_landmarks`` positions, BLESS-Nystrom attention, output
    projection. Decode keeps its full cache, as the reference's does.

    The reference's head layout: ``hp = cfg.padded_heads(TP)`` q heads and
    ``cfg.padded_kv_heads(TP)`` kv heads, q head h reading kv head
    ``h // (hp // kv heads)``; the padded q heads (h >= ``n_heads``) are
    multiplied by 0 before ``wo``."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator, dtype: torch.dtype,
                 device):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        hp, kvp = cfg.padded_heads(TP), cfg.padded_kv_heads(TP)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.wq = param(ninit((d, hp * hd), **kw))
        self.wk = param(ninit((d, kvp * hd), **kw))
        self.wv = param(ninit((d, kvp * hd), **kw))
        self.wo = param(ninit((hp * hd, d), **kw))
        if cfg.qk_norm:
            self.q_norm = param(torch.zeros((hd,), dtype=dtype, device=device))
            self.k_norm = param(torch.zeros((hd,), dtype=dtype, device=device))

    def _weights(self) -> tuple:
        """(wq, wk, wv, wo, q_norm, k_norm, q heads [lo, hi), kv heads) this
        rank computes with: the stored leaves outside a sharded run; on a
        mesh its share of the padded q heads (``model``) and the kv heads
        they read, gathered over ``model`` too where those do not line up
        with its block (fewer kv heads than ``model`` ranks: gemma-2b,
        qwen2-vl)."""
        cfg = self.cfg
        norms = (self.q_norm, self.k_norm) if cfg.qk_norm else (None, None)
        if tp.active() is None:
            q_lo, q_hi, _, kv = head_share(cfg, 1, 0)
            return (self.wq, self.wk, self.wv, self.wo, *norms, q_lo, q_hi, kv)
        ways = tp.model_axis().size
        q_lo, q_hi, kv_lo, kv_hi = head_share(cfg, ways, tp.model_axis().rank)
        if cfg.padded_kv_heads(TP) % ways == 0:  # the rank's kv block is what its q heads read
            wk, wv = tp.weight(self, "wk"), tp.weight(self, "wv")
        else:
            cols = slice(kv_lo * cfg.head_dim, kv_hi * cfg.head_dim)
            wk = tp.weight(self, "wk", gather_model=True)[:, cols]
            wv = tp.weight(self, "wv", gather_model=True)[:, cols]
        norms = tuple(n if n is None else tp.copy_to_model(n) for n in norms)
        return (tp.weight(self, "wq"), wk, wv, tp.weight(self, "wo"), *norms, q_lo, q_hi,
                kv_hi - kv_lo)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor | None,
             mrope_pos: torch.Tensor | None, w: tuple | None = None):
        cfg = self.cfg
        b, s, _ = x.shape
        wq, wk, wv, _, q_norm, k_norm, q_lo, q_hi, hkv = self._weights() if w is None else w
        q = lowp(x @ wq).reshape(b, s, q_hi - q_lo, cfg.head_dim)
        k = lowp(x @ wk).reshape(b, s, hkv, cfg.head_dim)
        v = lowp(x @ wv).reshape(b, s, hkv, cfg.head_dim)
        return self._positions(q, k, v, positions, mrope_pos, q_norm, k_norm)

    def _positions(self, q, k, v, positions, mrope_pos, q_norm, k_norm):
        """qk-norm and rotary positions of projected (B, S, H, D) q, k."""
        cfg = self.cfg
        if cfg.qk_norm:
            q = rms_norm(q, q_norm, cfg.norm_eps)
            k = rms_norm(k, k_norm, cfg.norm_eps)
        if cfg.pos == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        elif cfg.pos == "mrope":
            q = apply_mrope(q, mrope_pos, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, mrope_pos, cfg.rope_theta, cfg.mrope_sections)
        return q, k, v

    def _masked(self, out: torch.Tensor, q_lo: int, q_hi: int) -> torch.Tensor:
        """``out`` (..., h, D) of q heads [q_lo, q_hi) with the padded ones
        (h >= ``n_heads``) multiplied by 0, as the reference masks them."""
        n = self.cfg.n_heads
        if q_hi <= n:  # every head real: the reference's factor is 1
            return out
        keep = (torch.arange(q_lo, q_hi, device=out.device) < n).to(out.dtype)
        return out * keep[:, None]

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mrope_pos: torch.Tensor | None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        w = self._weights()
        q_lo, q_hi = w[6], w[7]
        q, k, v = self._qkv(tp.copy_to_model(x), positions, mrope_pos, w)
        if cfg.attention_impl == "bless_nystrom" and s > cfg.nystrom_landmarks:
            out = nystrom_attention(q, k, v, landmarks=cfg.nystrom_landmarks)
        else:
            out = attention(q, k, v, causal=cfg.causal, chunk=cfg.attn_chunk,
                            softcap=cfg.attn_logit_softcap)
        out = self._masked(out, q_lo, q_hi)
        return tp.reduce_from_model(out.reshape(b, s, (q_hi - q_lo) * cfg.head_dim) @ w[3])

    def decode(self, x: torch.Tensor, cache: dict, pos: torch.Tensor,
               length: torch.Tensor | None, mrope_pos: torch.Tensor | None) -> torch.Tensor:
        """One token per slot. x (B, 1, d); pos (B,) write positions; the
        cache's k/v rows at pos % max_len are written in place."""
        cfg = self.cfg
        b = x.shape[0]
        if tp.active() is not None:
            return self._decode_sharded(x, cache, pos, length, mrope_pos)
        q, k, v = self._qkv(x, pos.reshape(b, 1), mrope_pos)
        slot = pos % cache["k"].shape[1]
        bidx = torch.arange(b, device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], softcap=cfg.attn_logit_softcap,
                               length=length)
        hp = q.shape[2]
        return self._masked(out, 0, hp).reshape(b, 1, hp * cfg.head_dim) @ self.wo

    def _decode_sharded(self, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                        length: torch.Tensor | None,
                        mrope_pos: torch.Tensor | None) -> torch.Tensor:
        """``decode`` on a mesh, the cache in ``cache_specs``' blocks (its
        sequence over ``plan.kv``, the serve layouts' ``model`` or ``data``
        and ``model``). The new token's q, k, v come from the rank's
        columns and are gathered over ``model`` in one collective (every
        rank then has every padded head; gemma-2b's one kv head is split
        within its columns); the rank
        whose block holds ``pos % max_len`` writes the k / v row; each rank
        attends over its block, by global position for ``length``; the
        partials merge across the sequence's ranks for this rank's q heads,
        which, the padded ones masked, meet its ``wo`` rows in a partial
        summed over ``model``."""
        cfg = self.cfg
        plan = tp.active()
        b, hd = x.shape[0], cfg.head_dim
        hp, kvp = cfg.padded_heads(TP), cfg.padded_kv_heads(TP)
        q_lo, q_hi = head_share(cfg, tp.model_axis().size, tp.model_axis().rank)[:2]
        h = x[:, 0]
        q, k, v = (blk.reshape(b, -1)[:, :heads * hd].reshape(b, 1, heads, hd)
                   for blk, heads in zip(tp.model_blocks(*(h @ tp.weight(self, w)
                                                            for w in ("wq", "wk", "wv"))),
                                         (hp, kvp, kvp)))
        norms = (self.q_norm, self.k_norm) if cfg.qk_norm else (None, None)
        q, k, v = self._positions(q, k, v, pos.reshape(b, 1), mrope_pos, *norms)
        rows = cache["k"].shape[1]
        lo = plan.kv_index * rows
        local = pos % (rows * plan.kv_ways) - lo
        here = ((local >= 0) & (local < rows))[:, None, None]  # the slots whose row is here
        bidx, at = torch.arange(b, device=x.device), local.clamp(0, rows - 1)
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c[bidx, at] = torch.where(here, new[:, 0].to(c.dtype), c[bidx, at])
        acc, mx, den = decode_attention_partial(q, cache["k"], cache["v"],
                                                softcap=cfg.attn_logit_softcap, length=length,
                                                offset=lo)
        out = self._masked(tp.merge_attention(acc, mx, den, slice(q_lo, q_hi), q.dtype),
                           q_lo, q_hi)
        return tp.reduce_from_model(out.reshape(b, 1, (q_hi - q_lo) * hd)
                                    @ tp.weight(self, "wo"))


class Block(nn.Module):
    """Layer ``j`` of a period: pre-norm mixer, then pre-norm MLP, each residual."""

    def __init__(self, cfg: ArchConfig, j: int, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.ln_mix = param(torch.zeros((cfg.d_model,), dtype=dtype, device=device))
        self.mixer_kind = cfg.mixer_kind(j)
        if self.mixer_kind == "attn":
            self.attn = Attention(cfg, **kw)
        else:
            self.mamba = Mamba(cfg, **kw)
        self.mlp_kind = cfg.mlp_kind(j)
        if self.mlp_kind != "none":
            self.ln_mlp = param(torch.zeros((cfg.d_model,), dtype=dtype, device=device))
        if self.mlp_kind == "moe":
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.mlp_act,
                           capacity_factor=cfg.capacity_factor, shared_ff=cfg.shared_expert_ff,
                           mode=cfg.moe_mode(TP), **kw)
        elif self.mlp_kind == "dense":
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, **kw)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_kind == "none":
            return x
        h = rms_norm(x, self.ln_mlp, self.cfg.norm_eps)
        return x + (self.moe(h) if self.mlp_kind == "moe" else self.mlp(h))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mrope_pos: torch.Tensor | None) -> torch.Tensor:
        h = rms_norm(x, self.ln_mix, self.cfg.norm_eps)
        if self.mixer_kind == "attn":
            x = x + self.attn(h, positions, mrope_pos)
        else:
            x = x + self.mamba(h)
        return self._mlp(x)

    def decode(self, x: torch.Tensor, cache: dict, pos: torch.Tensor,
               length: torch.Tensor | None, mrope_pos: torch.Tensor | None) -> torch.Tensor:
        h = rms_norm(x, self.ln_mix, self.cfg.norm_eps)
        if self.mixer_kind == "attn":
            x = x + self.attn.decode(h, cache, pos, length, mrope_pos)
        else:
            x = x + self.mamba.decode(h, cache)
        return self._mlp(x)


class LM(nn.Module):
    """The LM stack of one ``ArchConfig``, built on ``device`` in the
    configuration's dtype with weights drawn from ``seed`` (the reference's
    initializers and scales; torch's generator, so not the reference's
    numbers: carry those across with ``repro_torch.interop``).

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run the plain versions of the kernels. On
    ``device="meta"`` the model holds no weights: a skeleton that
    ``torch.func.functional_call`` runs on a ``TrainState``'s params.
    """

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device: str = "cuda"):
        super().__init__()
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: LM runs on the card unless given device='cpu'")
        self.cfg = cfg
        dtype = model_dtype(cfg)
        gen = (None if torch.device(device).type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        kw = dict(generator=gen, dtype=dtype, device=device)
        vp, d = padded_vocab(cfg), cfg.d_model
        self.final_norm = param(torch.zeros((d,), dtype=dtype, device=device))
        if cfg.embed_inputs:
            # 1/sqrt(d) keeps tied-head logits O(1) at init
            self.embed = param(ninit((vp, d), scale=d ** -0.5, **kw))
        if not cfg.tie_embeddings or not cfg.embed_inputs:
            self.out_head = param(ninit((d, vp), **kw))
        self.layers = nn.ModuleList(Block(cfg, i % cfg.layer_period, **kw)
                                    for i in range(cfg.n_layers))
        # each leaf's full shape and logical axes, by module (read by
        # ``collectives.weight`` under a mesh) and by state_dict name
        self.logical = {}
        for prefix, mod in self.named_modules():
            mod.shard_layout = {}
            for leaf, t in mod.named_parameters(recurse=False):
                name = f"{prefix}.{leaf}" if prefix else leaf
                self.logical[name] = _logical(cfg, name, t.ndim)
                mod.shard_layout[leaf] = (tuple(t.shape), self.logical[name])

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def load_blocks(self, blocks: dict[str, torch.Tensor]) -> "LM":
        """Hold ``blocks`` (every leaf by ``state_dict`` name: a rank's blocks
        under ``param_specs``, as ``init_blocks`` or ``distribute_state``
        give them) as the parameters, without a gradient: a model to serve
        under that mesh (``decode_step``, ``ServeEngine``, ``prefill_logits``)
        from a weightless ``LM(cfg, device="meta")``. Returns ``self``."""
        names = dict(self.named_parameters())
        if set(blocks) != set(names):
            raise KeyError(f"blocks for {sorted(set(blocks) ^ set(names))[:5]}: not this model's "
                           "parameters")
        for name, t in blocks.items():
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
        return self

    def _embed_in(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.embed_inputs:  # audio: precomputed frame embeddings
            x = batch["frames"].to(model_dtype(cfg))
            return x + sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        if tp.model_axis().size > 1:
            table = tp.weight(self, "embed")
            x = tp.embed_lookup(table, batch["tokens"], tp.model_axis().rank * table.shape[0])
        else:
            x = tp.weight(self, "embed")[batch["tokens"]]
        if cfg.extra_image_tokens:  # vlm: patch embeds occupy a static prefix
            n = cfg.extra_image_tokens
            x = torch.cat([batch["pixel_embeds"].to(x.dtype), x[:, n:]], dim=1)
        return x

    def forward(self, batch: dict) -> torch.Tensor:
        """Full-sequence forward -> final hidden states (B, S, d). ``batch``
        holds "tokens" (B, S) (or "frames"), and optionally "positions",
        "mrope_positions" and "pixel_embeds", as the reference's does. When
        a gradient is taken and ``cfg.remat`` is set, each layer is
        recomputed in the backward instead of keeping its activations
        (``torch.utils.checkpoint``, non-reentrant)."""
        x = self._embed_in(batch)
        b, s, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        mrope_pos = batch.get("mrope_positions")
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(under_mesh_ctx(layer), x, positions, mrope_pos,
                               use_reentrant=False)
            else:
                x = layer(x, positions, mrope_pos)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def head(self) -> torch.Tensor:
        """The output projection (d, padded vocab): the tied embedding's
        transpose or ``out_head``; under a mesh this rank's vocabulary
        columns (``model``), gathered over ``data``."""
        if self.cfg.tie_embeddings:
            return tp.weight(self, "embed").T
        return tp.weight(self, "out_head")

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states (..., d) -> logits (..., padded vocab); under a
        mesh the rank's vocabulary block (columns from ``model``'s rank
        times the block's width)."""
        return tp.copy_to_model(h) @ self.head()

    def init_cache(self, batch_size: int, max_len: int, dtype=None) -> list[dict[str, Any]]:
        """One dict per layer: {"k", "v"} (B, max_len, Hkv, head_dim) for
        attention, {"conv" (B, k - 1, conv_dim), "state" (B, H, P, N) fp32}
        for Mamba; zeros on the model's device. Under a mesh ``batch_size``
        is the whole batch and each leaf is the rank's block of
        ``cache_specs`` under the ctx's ``kv_seq`` (``rules.serve_ctx``):
        ``local_shape``'s bytes, as the dry run counts them."""
        cfg = self.cfg
        dtype = dtype or model_dtype(cfg)
        kw = dict(device=self.device)
        plan = tp.active()
        if plan is not None:
            if batch_size % plan.batch_ways or max_len % plan.kv_ways:
                raise ValueError(f"a cache of {batch_size} x {max_len} does not split over "
                                 f"{plan.batch_ways} x {plan.kv_ways} ranks")
            specs = cache_specs(cfg, plan.ctx, seq_logical=plan.ctx.kv_seq)
        cache = []
        for i, layer in enumerate(self.layers):
            if layer.mixer_kind == "attn":
                kv = (batch_size, max_len, cfg.padded_kv_heads(TP), cfg.head_dim)
                shapes = {"k": (kv, dtype), "v": (kv, dtype)}
            else:
                shapes = {"conv": ((batch_size, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                   dtype),
                          "state": ((batch_size, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                                    torch.float32)}
            if plan is not None:
                shapes = {k: (local_shape(shape, specs[i][k], plan.ctx.mesh), dt)
                          for k, (shape, dt) in shapes.items()}
            cache.append({k: torch.zeros(shape, dtype=dt, **kw)
                          for k, (shape, dt) in shapes.items()})
        return cache

    @torch.no_grad()
    def decode_step(self, cache: list[dict], token: torch.Tensor, pos, *, length=None,
                    mrope_pos: torch.Tensor | None = None) -> torch.Tensor:
        """One decode step: token (B,) int, pos a scalar or (B,) write
        positions, ``length`` a scalar or (B,) count of valid cache rows.
        Updates ``cache`` in place; returns logits (B, padded vocab).

        Under a mesh (``rules.serve_ctx``'s layouts) ``token``, ``pos`` and
        ``length`` hold the rank's batch rows, ``cache`` is ``init_cache``'s
        blocks and the logits are the rank's rows and vocabulary block."""
        if not self.cfg.has_decode:
            raise ValueError(f"{self.cfg.name} is encoder-only")
        b = token.shape[0]
        pos = torch.as_tensor(pos, device=self.device).reshape(-1).expand(b)
        if length is not None:
            length = torch.as_tensor(length, device=self.device)
        if tp.model_axis().size > 1:
            table = tp.weight(self, "embed")
            x = tp.embed_lookup(table, token[:, None], tp.model_axis().rank * table.shape[0])
        else:
            x = tp.weight(self, "embed")[token][:, None, :]  # (B, 1, d)
        for layer, c in zip(self.layers, cache):
            x = layer.decode(x, c, pos, length, mrope_pos)
        return self.logits(rms_norm(x[:, 0], self.final_norm, self.cfg.norm_eps))


# =============================================================================
# sharding specs (leaf-name rules)
# =============================================================================

_SPEC_RULES: dict[str, tuple[str | None, ...]] = {
    # attention
    "wq": ("fsdp", "model"), "wk": ("fsdp", "model"), "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    # mlp
    "w_gate": ("fsdp", "model"), "w_up": ("fsdp", "model"), "w_down": ("model", "fsdp"),
    # mamba
    "in_proj": ("fsdp", "model"), "out_proj": ("model", "fsdp"),
    "conv_w": (None, "model"),
    # io
    "embed": ("model", "fsdp"), "out_head": ("fsdp", "model"),
    "router": (None, None),
}


def init_blocks(cfg: ArchConfig, specs: dict[str, PartitionSpec], mesh, *, seed: int = 0,
                device: str = "cuda", coords: dict[str, int] | None = None
                ) -> dict[str, torch.Tensor]:
    """This rank's blocks (``sharding.block`` under ``specs`` on ``mesh``; the
    rank at ``coords`` if given) of ``LM(cfg, seed=seed, device=device)``'s
    params, in ``named_parameters`` order: the same bits as
    ``distribute_state`` of that model, without ever holding it. The model
    is built in its construction order with each leaf drawn whole from the
    seed's generator, cut to its block and dropped before the next is drawn,
    so a rank holds at most one whole leaf beside its blocks."""
    made: list[nn.Parameter] = []
    layers._ON_PARAM.append(lambda p: made.append(p) or p)
    try:
        names = {id(p): n for n, p in LM(cfg, device="meta").named_parameters()}
    finally:
        layers._ON_PARAM.pop()
    order = iter([names[id(p)] for p in made])
    blocks: dict[str, torch.Tensor] = {}

    def keep(p: nn.Parameter) -> nn.Parameter:
        name = next(order)
        with torch.no_grad():
            blocks[name] = rules.block(p, specs[name], mesh, coords).clone(
                memory_format=torch.contiguous_format)
        return nn.Parameter(blocks[name], requires_grad=False)

    layers._ON_PARAM.append(keep)
    try:
        LM(cfg, seed=seed, device=device)
    finally:
        layers._ON_PARAM.pop()
    return {n: blocks[n] for n in names.values()}


def _moe_spec(cfg: ArchConfig, name: str) -> tuple[str | None, ...]:
    mode = cfg.moe_mode(TP)
    if name in ("w_gate", "w_up"):
        return {"ep": ("model", "fsdp", None), "tp": (None, "fsdp", "model"),
                "replicate": (None, "fsdp", None)}[mode]
    return {"ep": ("model", None, "fsdp"), "tp": (None, "model", "fsdp"),
            "replicate": (None, None, "fsdp")}[mode]


def _logical(cfg: ArchConfig, name: str, ndim: int) -> tuple[str | None, ...]:
    """The logical axes of the ``state_dict`` entry ``name`` (``ndim`` dims)."""
    keys = name.split(".")
    leaf = keys[-1]
    in_moe = "moe" in keys and "shared" not in keys  # shared expert = dense MLP
    if in_moe and leaf in ("w_gate", "w_up", "w_down"):
        logical = _moe_spec(cfg, leaf)
    elif leaf in _SPEC_RULES:
        logical = _SPEC_RULES[leaf]
    else:
        logical = (None,) * ndim
    if len(logical) != ndim:
        raise ValueError(f"{name}: {ndim} dimensions against the rule {logical}")
    return logical


def param_specs(cfg: ArchConfig, ctx: MeshCtx) -> dict[str, PartitionSpec]:
    """PartitionSpec of every ``LM(cfg).state_dict()`` entry, by name (built
    from a weightless ``LM(cfg, device="meta")``)."""
    lm = LM(cfg, device="meta")
    return {name: logical_to_spec(*lm.logical[name], ctx=ctx) for name in lm.state_dict()}


def cache_specs(cfg: ArchConfig, ctx: MeshCtx, *,
                seq_logical: str = "none") -> list[dict[str, PartitionSpec]]:
    """Sharding for ``LM.init_cache``'s per-layer dicts. seq_logical: 'none'
    (replicated seq), 'seq_shard' (data), 'seq_model' (model; a rule
    ``rules.serve_ctx`` adds) or 'seq_shard_wide' (data+model) for
    long-context."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) == "attn":
            kv = logical_to_spec("batch", seq_logical, None, None, ctx=ctx)
            out.append({"k": kv, "v": kv})
        else:
            out.append({"conv": logical_to_spec("batch", None, "model", ctx=ctx),
                        "state": logical_to_spec("batch", "model", None, None, ctx=ctx)})
    return out


def logits_fn(lm: LM, h: torch.Tensor) -> torch.Tensor:
    """The reference's ``logits_fn``: hidden states -> padded-vocab logits."""
    return lm.logits(h)


def _chunk_nll(hc: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """-sum of the log-likelihoods of one sequence chunk: logits in the
    model's dtype, then fp32, padded vocabulary at -1e30."""
    logits = (hc @ w).float()
    logits = torch.where(valid, logits, logits.new_full((), -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 2, labels[..., None])[..., 0] - lse
    return -torch.sum(ll)


def _chunk_nll_vocab(hc: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                     valid: torch.Tensor, lo: int) -> torch.Tensor:
    """``_chunk_nll`` of a vocabulary split over ``model`` (``w`` holds the
    columns from ``lo``): its log-sum-exp reduced over the axis."""
    logits = (hc @ w).float()
    logits = torch.where(valid, logits, logits.new_full((), -1e30))
    return tp.vocab_nll(logits, labels, lo)


def loss_fn(lm: LM, batch: dict, *, n_chunks: int = 8) -> torch.Tensor:
    """Chunked softmax cross-entropy, the reference's ``loss_fn``: the
    logits exist one sequence chunk at a time ((B, S / n, Vp)), never as
    (B, S, Vp); the chunk sums are added and divided by B S. When a
    gradient is taken each chunk is checkpointed, so its logits are
    recomputed in the backward rather than kept. ``batch`` adds "labels"
    (B, S) to the forward's inputs.

    Under a mesh ``batch`` holds the rank's rows and the result is its share
    of the loss: its rows' sum over the global B S (``collectives.sum_over_batch``
    adds the shares); over ``model`` the cross-entropy is vocabulary-parallel."""
    h = lm(batch)
    b, s, _ = h.shape
    w = lm.head()
    n_chunks = min(n_chunks, s)
    if s % n_chunks:
        raise ValueError(f"S = {s} is not a multiple of n_chunks = {n_chunks}")
    sc = s // n_chunks
    plan = tp.active()
    fn, lo = _chunk_nll, 0
    if tp.model_axis().size > 1:
        h = tp.copy_to_model(h)
        lo = tp.model_axis().rank * w.shape[1]
        fn = functools.partial(_chunk_nll_vocab, lo=lo)
    valid = torch.arange(lo, lo + w.shape[1], device=h.device) < lm.cfg.vocab_size
    labels = batch["labels"]
    grad = torch.is_grad_enabled()
    sums = []
    for i in range(n_chunks):
        args = (h[:, i * sc:(i + 1) * sc], labels[:, i * sc:(i + 1) * sc], w, valid)
        sums.append(checkpoint(under_mesh_ctx(fn), *args, use_reentrant=False) if grad
                    else fn(*args))
    rows = b * (plan.batch_ways if plan is not None else 1)
    return torch.sum(torch.stack(sums)) / (rows * s)
