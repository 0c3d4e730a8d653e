"""Serving: the parallel prompt forward and a continuous-batching engine."""
from .engine import ServeEngine, prefill, prefill_logits, sample_greedy

__all__ = ["ServeEngine", "prefill", "prefill_logits", "sample_greedy"]
