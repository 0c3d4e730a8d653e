"""The LM stack: configuration, layers, attention, Mamba-2, MoE and the model."""
from .config import ArchConfig
from .model import (LM, cache_specs, init_blocks, logits_fn, loss_fn, model_dtype,
                    padded_vocab, param_specs)

__all__ = ["ArchConfig", "LM", "cache_specs", "init_blocks", "logits_fn", "loss_fn",
           "model_dtype", "padded_vocab", "param_specs"]
