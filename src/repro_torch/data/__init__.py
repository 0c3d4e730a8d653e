"""Deterministic, resumable token pipelines."""
from .pipeline import SyntheticLM, TokenPipeline

__all__ = ["SyntheticLM", "TokenPipeline"]
