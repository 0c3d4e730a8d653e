"""hubert-xlarge [audio] — encoder-only (w2v2 arch); conv frame frontend is a
stub per spec: inputs are precomputed frame embeddings. [arXiv:2106.07447]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    mlp_act="gelu", causal=False, has_decode=False, embed_inputs=False,
    pos="sinusoidal",
)
