"""``repro_torch.stream``: the out-of-core streaming subsystem (DESIGN.md §10).

``ChunkStore`` keeps (X, y) in host memory (pinned for the card) in
fixed-size row chunks; ``StreamBackend`` serves the full kernel-operator
``Backend`` protocol by double-buffered chunk streaming (copy chunk i+1
while contracting chunk i), so FALKON, the samplers, predict and the
estimators run at n beyond device memory with no (n, M) array ever built.
Registered as ``"stream"``; ``"stream:cuda"`` / ``"stream:torch"`` name the
per-tile backend.
"""
from .backend import MATERIALIZE_ELEMS, StreamBackend
from .store import (
    STREAM_CHUNK,
    ChunkStore,
    default_chunk,
    device_chunks,
    device_memory_stats,
    peak_device_bytes,
    reset_peak_device_bytes,
)

__all__ = [
    "ChunkStore",
    "StreamBackend",
    "STREAM_CHUNK",
    "MATERIALIZE_ELEMS",
    "default_chunk",
    "device_chunks",
    "device_memory_stats",
    "peak_device_bytes",
    "reset_peak_device_bytes",
]
