"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA-as-GQA kv=32. [arXiv:2404.14219]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32_064,
)
