"""minicpm-2b [dense] — llama-like, MHA 36 heads, WSD schedule (optimizer).
[arXiv:2404.06395]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122_753,
    tie_embeddings=True,
)
