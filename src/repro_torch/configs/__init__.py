"""Architecture registry: ``--arch <id>`` resolves here (a copy of the
reference's ``repro.configs``; the config modules are data, copied whole).

One module per assigned architecture (exact configs from the public pool)
plus the paper's own FALKON workloads. ``smoke(cfg)`` derives the reduced
same-family config used by per-arch CPU smoke tests.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig
from . import (gemma_2b, granite_moe_3b_a800m, hubert_xlarge, jamba_v0_1_52b,
               llama4_scout_17b_a16e, mamba2_370m, minicpm_2b, phi3_mini_3_8b,
               qwen2_vl_2b, qwen3_32b)

_REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (mamba2_370m, llama4_scout_17b_a16e, granite_moe_3b_a800m, gemma_2b,
              minicpm_2b, phi3_mini_3_8b, qwen3_32b, qwen2_vl_2b, jamba_v0_1_52b,
              hubert_xlarge)
}


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small width/depth, tiny vocab/experts."""
    few_layers = cfg.layer_period if cfg.layer_period > 1 else 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=few_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        shared_expert_ff=128 if cfg.shared_expert_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32,
        extra_image_tokens=16 if cfg.extra_image_tokens else 0,
        nystrom_landmarks=min(cfg.nystrom_landmarks, 32),
        attn_chunk=64,
    )
