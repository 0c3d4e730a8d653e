"""mamba2-370m [ssm] — SSD, attention-free. [arXiv:2405.21060]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_headdim=64,
    tie_embeddings=True,
)
