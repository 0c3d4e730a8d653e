"""Analytic FLOP / HBM-byte model for the roofline, and a FLOP counter.

The port of ``repro.launch.cost_model`` (plain arithmetic over
``ArchConfig``, copied). It counts the q heads padded to the reference's
16-way model axis (``models.config.TP``) as spent FLOPs, as the reference
does: the port's models compute them (``models.model``).

Conventions: matmul (m,k)x(k,n) = 2mkn FLOPs. Train = fwd + 2x bwd + 1x
remat re-fwd = 4x fwd matmul FLOPs. Padded q-heads and MoE capacity slots
are counted as spent FLOPs (they are).

``flop_count(fn, *args)`` is the counterpart of the reference's
``xla_cost_analysis``: the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
sees in one call of ``fn``. Its arguments lie on the meta device (no memory,
no compute) or the CPU. There K8 and K9 run their plain versions
(``kernels/*/ref.py``), whose products the counter sees; on the card their
launches are invisible to it (they are no ATen operators), so a CUDA
argument raises rather than count 0 for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.config import TP, ArchConfig
from ..models.model import padded_vocab


def flop_count(fn: Callable, *args: Any) -> dict:
    """{"flops": total} of one ``fn(*args)``, the arguments (tensors, or
    dicts, lists and tuples of them) on the meta device or the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    def devices(a):
        if isinstance(a, torch.Tensor):
            return {a.device.type}
        if isinstance(a, dict):
            a = list(a.values())
        if isinstance(a, (list, tuple)):
            return set().union(*map(devices, a)) if a else set()
        return set()

    if "cuda" in devices(list(args)):
        raise ValueError("flop_count takes meta or CPU tensors: on the card the kernels' "
                         "launches are invisible to the counter")
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


@dataclasses.dataclass
class CostBreakdown:
    flops_fwd: float  # one forward pass, whole job
    hbm_bytes: float  # per-device traffic per step
    breakdown: dict


def _attn_layer_flops(cfg: ArchConfig, tokens: int, s_kv: int) -> float:
    hp, kvp = cfg.padded_heads(TP), cfg.padded_kv_heads(TP)
    hd, d = cfg.head_dim, cfg.d_model
    proj = 2 * tokens * d * (hp * hd) * 2  # wq + wo
    proj += 2 * tokens * d * (kvp * hd) * 2  # wk + wv
    if cfg.attention_impl == "bless_nystrom" and s_kv > cfg.nystrom_landmarks:
        m = cfg.nystrom_landmarks
        core = 2 * tokens * m * (hp * hd) * 2  # F1, F2-style products
        core += 2 * tokens * m * m  # pinv application (amortized)
        core += 2 * tokens * m * hd * hp  # (F2 V) and landmark matmuls
    else:
        causal_frac = 0.5 if cfg.causal and tokens == s_kv else 1.0
        core = 2 * 2 * tokens * s_kv * (hp * hd) * causal_frac  # QK^T + PV
    return proj + core


def _mamba_layer_flops(cfg: ArchConfig, tokens: int, chunk: int = 256) -> float:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    proj = 2 * tokens * d * (2 * di + 2 * ns + cfg.ssm_heads)  # in_proj
    proj += 2 * tokens * di * d  # out_proj
    conv = 2 * tokens * (di + 2 * ns) * cfg.ssm_conv
    q = min(chunk, tokens)
    # chunked SSD einsums (B*nc*Q = tokens):
    #   CB^T: Q*ns/token; y_diag: Q*di/token; states+y_off: 2*di*ns/token
    ssd = 2 * tokens * (q * ns + q * di + 2 * di * ns)
    return proj + conv + ssd


def _mlp_flops(cfg: ArchConfig, tokens: int) -> float:
    mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    return 2 * tokens * cfg.d_model * cfg.d_ff * mult


def _moe_layer_flops(cfg: ArchConfig, tokens: int, seq: int) -> float:
    mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    router = 2 * tokens * cfg.d_model * cfg.n_experts
    capacity = max(8, int(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    groups = tokens // seq
    expert_tokens = groups * cfg.n_experts * capacity  # capacity slots are spent
    expert = 2 * expert_tokens * cfg.d_model * cfg.d_ff * mult
    shared = (2 * tokens * cfg.d_model * cfg.shared_expert_ff * mult
              if cfg.shared_expert_ff else 0)
    return router + expert + shared


def forward_flops(cfg: ArchConfig, batch: int, seq: int, *, s_kv: int | None = None,
                  decode: bool = False) -> CostBreakdown:
    """One forward pass over batch x seq tokens (decode: seq=1, s_kv=cache)."""
    tokens = batch * seq
    s_kv = s_kv or seq
    vp = padded_vocab(cfg)
    br = {"embed_logits": 2 * tokens * cfg.d_model * vp if cfg.embed_inputs or True else 0}
    attn = mamba = mlp = moe = 0.0
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) == "attn":
            attn += _attn_layer_flops(cfg, tokens, s_kv)
        else:
            if decode:
                # recurrent step: state update + conv + projections
                d, di, ns, nh, hp = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                     cfg.ssm_heads, cfg.ssm_headdim)
                mamba += 2 * tokens * (d * (2 * di + 2 * ns + nh) + di * d)
                mamba += 2 * tokens * nh * hp * ns * 2
            else:
                mamba += _mamba_layer_flops(cfg, tokens)
        kind = cfg.mlp_kind(i)
        if kind == "dense":
            mlp += _mlp_flops(cfg, tokens)
        elif kind == "moe":
            moe += _moe_layer_flops(cfg, tokens, seq)
    br.update(attn=attn, mamba=mamba, mlp=mlp, moe=moe)
    total = sum(br.values())
    return CostBreakdown(flops_fwd=total, hbm_bytes=0.0, breakdown=br)


def param_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    return cfg.param_count() * dtype_bytes


def step_costs(cfg: ArchConfig, shape_kind: str, batch: int, seq: int, chips: int,
               *, s_kv: int | None = None) -> dict:
    """Per-device FLOPs and HBM bytes for one step of the given kind."""
    decode = shape_kind == "decode"
    fb = forward_flops(cfg, batch, 1 if decode else seq,
                       s_kv=s_kv or seq, decode=decode)
    if shape_kind == "train":
        total_flops = 4.0 * fb.flops_fwd  # fwd + re-fwd(remat) + 2x bwd
    else:
        total_flops = fb.flops_fwd
    flops_dev = total_flops / chips

    p_bytes = param_bytes(cfg)  # bf16 weights
    if shape_kind == "train":
        # params read twice (fwd+refwd) + grads written + adam: master/mu/nu
        # read+write in fp32 (3 * 4B * 2) + bf16 param write
        w_traffic = p_bytes * 2 + p_bytes + cfg.param_count() * (3 * 4 * 2 + 2)
        act = 2 * batch * seq * cfg.d_model * cfg.n_layers * 2  # ckpt in+out
        traffic = w_traffic + act * 2
    elif shape_kind == "prefill":
        act = 2 * batch * seq * cfg.d_model * cfg.n_layers * 2
        traffic = p_bytes + act
    else:  # decode: weights + full KV/state read per token
        kv = 0
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) == "attn":
                kv += 2 * batch * (s_kv or seq) * cfg.padded_kv_heads(TP) * cfg.head_dim * 2
            else:
                kv += batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        traffic = p_bytes + kv
    return {"flops_per_device": flops_dev, "hbm_bytes_per_device": traffic / chips,
            "flops_breakdown": fb.breakdown, "flops_total": total_flops}
