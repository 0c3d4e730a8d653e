"""Durable online FALKON: crash-resumable streamed fits, incremental updates
and warm refits over streamed normal-equation accumulators (DESIGN.md §11).
Sits above stream / checkpoint / core and below api."""
from .accumulate import absorb, solve_accumulators
from .durable import ResumeMismatchError, fit_config_hash, resumable_streamed_fit
from .online import OnlineFalkon

__all__ = ["OnlineFalkon", "ResumeMismatchError", "absorb",
           "fit_config_hash", "resumable_streamed_fit", "solve_accumulators"]
