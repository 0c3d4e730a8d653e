"""Architecture configuration: a copy of the reference's ``repro.models.config``.

The port keeps its own copy (the reference module imports no JAX, but the
port imports nothing of the reference). ``TP`` is the reference's
production model-axis width (its ``repro.models.model.TP``), kept here once:
``padded_heads(TP)`` and ``padded_kv_heads(TP)`` give the attention heads
every model is built with, on one card and on any mesh (the reference's
layout, ROADMAP C.2c), and ``moe_mode(TP)`` a MoE layer's layout.

One frozen dataclass describes every assigned arch (dense / MoE / SSM /
hybrid / VLM-backbone / audio-encoder). ``block_kind(i)`` resolves the
per-layer mixer/mlp pattern (Jamba's 1:7 attn:mamba interleave with MoE on
odd layers, etc.); ``layer_period`` is the pattern period — the layer stack
scans over ``n_layers // layer_period`` stacked parameter groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

#: the reference's production model-axis width: attention q heads are padded
#: to a multiple of it and MoE layouts are chosen by it.
TP = 16

Mixer = Literal["attn", "mamba"]
Mlp = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    causal: bool = True
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos: str = "rope"  # rope | mrope | sinusoidal
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # of head_dim//2
    attention_impl: str = "full"  # full | bless_nystrom
    nystrom_landmarks: int = 1024  # for bless_nystrom
    attn_logit_softcap: float = 0.0

    # mlp
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1  # every `moe_period`-th layer is MoE (when n_experts>0)
    shared_expert_ff: int = 0  # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    moe_sharding: str = "auto"  # auto | ep (experts->model) | tp (ff->model)
    #                             | replicate (small experts: no model shard)
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64
    attn_period: int = 0  # hybrid: 1 attention layer per `attn_period` (jamba=8)
    attn_offset: int = 4  # position of the attn layer inside a period group

    # embeddings / io
    tie_embeddings: bool = False
    embed_inputs: bool = True  # False => inputs are precomputed embeddings (audio)
    extra_image_tokens: int = 0  # vlm: prefix patch-embeds scattered into seq
    has_decode: bool = True  # encoder-only archs: False

    # numerics / distribution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: bool = True
    attn_chunk: int = 512  # q-chunk for memory-bounded full attention

    # --- derived -----------------------------------------------------------
    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def layer_period(self) -> int:
        p = 1
        if self.attn_period:
            p = self.attn_period
        if self.n_experts and self.moe_period > 1:
            p = _lcm(p, self.moe_period)
        return p

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.layer_period == 0, (self.n_layers, self.layer_period)
        return self.n_layers // self.layer_period

    def mixer_kind(self, i: int) -> Mixer:
        if self.family == "ssm":
            return "mamba"
        if self.attn_period:
            return "attn" if i % self.attn_period == self.attn_offset else "mamba"
        return "attn"

    def mlp_kind(self, i: int) -> Mlp:
        if self.d_ff == 0 and not self.n_experts:
            return "none"
        if self.n_experts and i % self.moe_period == self.moe_period - 1:
            return "moe"
        return "dense"

    def moe_mode(self, tp: int = 16) -> str:
        """'ep' (experts->model), 'tp' (per-expert ff->model) or
        'replicate' (tiny experts: keep MoE weights model-replicated; all
        dispatch/compute batch-parallel, zero MoE collectives)."""
        if self.moe_sharding != "auto":
            return self.moe_sharding
        if self.n_experts % tp == 0:
            return "ep"
        return "tp" if self.d_ff >= 64 * tp else "replicate"

    def moe_ep(self, tp: int = 16) -> bool:
        return self.moe_mode(tp) == "ep"

    def padded_heads(self, tp: int = 16) -> int:
        """q-heads padded to a multiple of the model axis (zero o_proj rows —
        exact; the overhead is reported in the roofline waste ratio)."""
        return math.ceil(self.n_heads / tp) * tp

    def padded_kv_heads(self, tp: int = 16) -> int:
        """kv heads beside ``padded_heads(tp)`` q heads: padded with them
        under MHA (``n_kv_heads == n_heads``), else ``n_kv_heads``. q head h
        reads kv head ``h // (padded_heads // padded_kv_heads)``."""
        return self.padded_heads(tp) if self.n_kv_heads == self.n_heads else self.n_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        total = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            d = self.d_model
            if self.mixer_kind(i) == "attn":
                qkv = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
                total += qkv + self.n_heads * self.head_dim * d
                if self.qk_norm:
                    total += 2 * self.head_dim
            else:
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + nh)  # in_proj (z,x,B,C,dt)
                total += (di + 2 * ns) * self.ssm_conv  # conv
                total += 3 * nh + di  # A_log, dt_bias, D, norm... (approx)
                total += di * d  # out_proj
            kind = self.mlp_kind(i)
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            if kind == "dense":
                total += mult * d * self.d_ff
            elif kind == "moe":
                total += d * self.n_experts  # router
                total += self.n_experts * mult * d * self.d_ff
                if self.shared_expert_ff:
                    total += mult * d * self.shared_expert_ff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k experts + shared)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.mlp_kind(i) == "moe")
        inactive = n_moe_layers * (self.n_experts - self.top_k) * mult * self.d_model * self.d_ff
        return total - inactive


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
