"""Gradient compression for all-reduces, and the fault-tolerant train loop."""
from .compress import (compressed_allreduce_int8, compressed_psum_bf16, ef_state_init,
                       int8_compress, int8_decompress)
from .monitor import FaultTolerantLoop, HeartbeatMonitor

__all__ = ["compressed_allreduce_int8", "compressed_psum_bf16", "ef_state_init",
           "int8_compress", "int8_decompress", "FaultTolerantLoop", "HeartbeatMonitor"]
