"""llama4-scout-17b-16e [moe] — MoE 16e top-1 + shared expert, GQA kv=8.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, moe_period=1, shared_expert_ff=8192,
    rope_theta=500_000.0,
)
