"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 every
other layer. [arXiv:2403.19887]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=65_536,
    n_experts=16, top_k=2, moe_period=2,
    attn_period=8, attn_offset=4,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_headdim=64,
)
