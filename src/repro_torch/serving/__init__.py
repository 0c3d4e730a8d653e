"""Serving: KRR micro-batching (``KrrServer``), the fault-tolerant async
KRR server (``AsyncKrrServer``), and the LM stack's parallel prompt forward
and continuous-batching engine."""
from .async_krr import AsyncKrrServer, QueueFull, RequestStatus, ServeConfig
from .engine import ServeEngine, prefill, prefill_logits, sample_greedy
from .krr import KrrServer, pow2_bucket, probe_model

__all__ = ["ServeEngine", "prefill", "prefill_logits", "sample_greedy", "KrrServer",
           "pow2_bucket", "probe_model", "AsyncKrrServer", "ServeConfig",
           "RequestStatus", "QueueFull"]
