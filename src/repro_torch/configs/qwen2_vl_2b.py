"""qwen2-vl-2b [vlm] — M-RoPE, dynamic-resolution vision (frontend stubbed:
input_specs provides precomputed patch embeddings). [arXiv:2409.12191]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151_936,
    pos="mrope", mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    extra_image_tokens=1024, tie_embeddings=True,
)
