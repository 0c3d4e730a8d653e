"""The LM stack: configuration, layers, attention, Mamba-2, MoE and the model."""
from .config import ArchConfig
from .model import LM, logits_fn, loss_fn, model_dtype, padded_vocab

__all__ = ["ArchConfig", "LM", "logits_fn", "loss_fn", "model_dtype", "padded_vocab"]
