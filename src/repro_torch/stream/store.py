"""Host-resident chunked data plane for the out-of-core streaming backend.

The PyTorch counterpart of ``repro.stream.store``. ``ChunkStore`` keeps X
(and optionally y) in host memory as C-contiguous fp32 rows, in **pinned**
(page-locked) buffers when its device is the card, and hands them to the
device one chunk at a time. The device only ever sees a bounded working
set: at most two X chunks (the one being contracted and the prefetched
next), one transient (chunk, M) Gram tile per contraction, and the O(M) /
(M, k) accumulators or the O(n) prediction output.

``device_chunks`` is the double-buffered copy loop. On the card the copy of
chunk i+1 is issued (``non_blocking`` from pinned memory, on a side
stream made for the call) before chunk i is yielded, so it overlaps the
contraction of chunk i; the consumer's stream waits on the chunk's event,
and ``record_stream`` tells the caching allocator that the consumer's
stream still reads the chunk, so its block is not handed to the next copy
while a kernel reads it.

The subsystem keeps its own byte meter (``peak_device_bytes``), with the
reference's arithmetic, so CPU tests can compare it with the reference's;
``device_memory_stats`` gives the allocator's own view on the card.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..core.backend import require_cuda_device

Tensor = torch.Tensor

#: Default rows per device chunk by device type (the reference's
#: ``STREAM_CHUNK`` for "cpu" and "gpu").
STREAM_CHUNK = {"cpu": 16384, "cuda": 65536}


def default_chunk(device: torch.device | str = "cuda") -> int:
    """Default rows per chunk for ``device`` (see ``STREAM_CHUNK``)."""
    return STREAM_CHUNK.get(torch.device(device).type, 16384)


# ---------------------------------------------------------------------------
# Device-byte accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _DeviceBytes:
    """Bytes the stream subsystem currently has resident on the device,
    plus the high-water mark; guarded by a lock (several host threads may
    stream at once)."""

    current: int = 0
    peak: int = 0
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def add(self, nbytes: int) -> None:
        with self.lock:
            self.current += nbytes
            self.peak = max(self.peak, self.current)

    def sub(self, nbytes: int) -> None:
        with self.lock:
            self.current = max(0, self.current - nbytes)

    def note_transient(self, nbytes: int) -> None:
        """Record a short-lived allocation (a Gram tile) that never outlives
        one loop iteration: bumps the peak without moving ``current``."""
        with self.lock:
            self.peak = max(self.peak, self.current + nbytes)


_TRACKER = _DeviceBytes()


def reset_peak_device_bytes() -> None:
    """Zero the subsystem's device-byte high-water mark."""
    with _TRACKER.lock:
        _TRACKER.current = 0
        _TRACKER.peak = 0


def peak_device_bytes() -> int:
    """High-water mark of the device bytes the stream subsystem placed
    (chunks in flight, transient Gram tiles) since the last reset."""
    return _TRACKER.peak


def device_memory_stats(device: torch.device | str = "cuda") -> dict | None:
    """The caching allocator's stats on a CUDA ``device``
    (``torch.cuda.memory_stats``; ``allocated_bytes.all.peak`` is the real
    peak), or None for the CPU."""
    device = torch.device(device)
    return torch.cuda.memory_stats(device) if device.type == "cuda" else None


def _nbytes(a: Tensor) -> int:
    return a.numel() * a.element_size()


def _as_host(a) -> Tensor:
    """``a`` (numpy, list or a tensor on any device) as a contiguous fp32
    CPU tensor (it may share memory with ``a``)."""
    if isinstance(a, Tensor):
        return a.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _owned(t: Tensor, pin: bool) -> Tensor:
    """A copy of the CPU tensor ``t`` that the store owns, pinned when ``pin``."""
    out = torch.empty(t.shape, dtype=torch.float32, pin_memory=pin)
    out.copy_(t)
    return out


# ---------------------------------------------------------------------------
# ChunkStore
# ---------------------------------------------------------------------------


class ChunkStore:
    """Host-resident (X, y) exposed as fixed-size row chunks.

    Array-like enough to flow through the seams unchanged: it has
    ``shape`` / ``ndim`` / ``dtype`` / ``device`` / ``len`` and an indexing
    gather (rows -> a small tensor on ``device``), which is how the
    estimators and samplers pull center coordinates out of it.

    Args:
      x: (n, d) rows (numpy or a tensor on any device); copied to host.
      y: optional aligned (n,) or (n, k) targets, chunked in lockstep.
      chunk: rows per chunk (the last chunk carries the remainder); None
        takes ``default_chunk(device)``.
      device: where chunks go: "cuda" (default; pinned host buffers,
        raising without a card) or "cpu" (plain host buffers).
    """

    def __init__(self, x, y=None, *, chunk: int | None = None,
                 device: torch.device | str = "cuda"):
        self.device = require_cuda_device(device)
        self._pin = self.device.type == "cuda"
        xb = _owned(_as_host(x), self._pin)
        if xb.ndim != 2:
            raise ValueError(f"ChunkStore x must be (n, d), got {tuple(xb.shape)}")
        self._n = xb.shape[0]
        self._xbuf = xb
        self._ybuf = None
        if y is not None:
            yb = _owned(_as_host(y), self._pin)
            if yb.shape[0] != self._n:
                raise ValueError(f"y rows {yb.shape[0]} != x rows {self._n}")
            self._ybuf = yb
        self.chunk = max(1, int(chunk) if chunk is not None else default_chunk(self.device))

    def _grown(self, buf: Tensor, cap: int) -> Tensor:
        out = torch.empty((cap,) + tuple(buf.shape[1:]), dtype=torch.float32,
                          pin_memory=self._pin)
        out[: self._n] = buf[: self._n]
        return out

    def append(self, x_new, y_new=None) -> int:
        """Append rows (capacity-doubling host buffers, amortized O(1));
        returns the new row count. Existing rows never change value: ``x`` /
        ``y`` views of a prefix stay valid while appends continue."""
        xb = _as_host(x_new)
        if xb.ndim != 2 or xb.shape[1] != self._xbuf.shape[1]:
            raise ValueError(f"append rows must be (r, {self._xbuf.shape[1]}), "
                             f"got {tuple(xb.shape)}")
        yb = None
        if self._ybuf is not None:
            if y_new is None:
                raise ValueError("this store carries y; append needs y_new")
            yb = _as_host(y_new)
            if yb.shape[0] != xb.shape[0] or yb.shape[1:] != self._ybuf.shape[1:]:
                raise ValueError(
                    f"y_new shape {tuple(yb.shape)} does not match {xb.shape[0]} "
                    f"rows of {tuple(self._ybuf.shape[1:])} targets")
        elif y_new is not None:
            raise ValueError("this store has no y; cannot append y_new")
        need = self._n + xb.shape[0]
        if need > self._xbuf.shape[0]:
            cap = max(need, 2 * self._xbuf.shape[0])
            self._xbuf = self._grown(self._xbuf, cap)
            if self._ybuf is not None:
                self._ybuf = self._grown(self._ybuf, cap)
        self._xbuf[self._n:need] = xb
        if yb is not None:
            self._ybuf[self._n:need] = yb
        self._n = need
        return self._n

    # -- array-like surface --------------------------------------------------

    @property
    def x(self) -> Tensor:
        """The host (n, d) fp32 X: a contiguous view of the growth buffer."""
        return self._xbuf[: self._n]

    @property
    def y(self) -> Tensor | None:
        """The host (n,) / (n, k) fp32 targets (None when not stored)."""
        return None if self._ybuf is None else self._ybuf[: self._n]

    @property
    def shape(self) -> tuple[int, int]:
        """(n, d) of the stored X."""
        return (self._n, self._xbuf.shape[1])

    @property
    def ndim(self) -> int:
        """Always 2 (rows x features)."""
        return 2

    @property
    def dtype(self) -> torch.dtype:
        """fp32, the storage and transfer dtype."""
        return torch.float32

    def __len__(self) -> int:
        return self._n

    @property
    def n_chunks(self) -> int:
        """Number of row chunks (ceil(n / chunk))."""
        return -(-self._n // self.chunk)

    def chunk_slices(self) -> list[slice]:
        """The row slice of every chunk, in streaming order."""
        n, c = self._n, self.chunk
        return [slice(i, min(i + c, n)) for i in range(0, n, c)]

    def __getitem__(self, idx) -> Tensor:
        """Row gather -> a tensor on ``device`` (centers, candidate sets).
        Accepts an int, a slice, or an integer index array (numpy, or a
        tensor on any device; a CUDA index tensor is brought to the host)."""
        if isinstance(idx, Tensor):
            idx = idx.cpu()
        elif not isinstance(idx, (int, np.integer, slice)):
            idx = torch.from_numpy(np.asarray(idx))
        return self.x[idx].to(self.device)

    def to_device(self) -> Tensor:
        """The whole X as one device tensor: O(n d), never O(n M)."""
        return self.x.to(self.device)


# ---------------------------------------------------------------------------
# Double-buffered chunk iteration
# ---------------------------------------------------------------------------


def _is_host(a, dev: torch.device) -> bool:
    """True for rows that must be copied to ``dev`` (numpy, or a tensor on
    another device)."""
    return isinstance(a, np.ndarray) or (isinstance(a, Tensor) and a.device != dev)


def device_chunks(x, aux=None, *, chunk: int | None = None,
                  device: torch.device | str | None = None):
    """Yield ``(xb, auxb)`` device chunks of ``x`` (and the aligned optional
    ``aux`` rows: targets, masks) with one-chunk prefetch.

    ``x`` may be a ``ChunkStore`` (its chunks are always copied and counted,
    so the byte meter reads the same on the CPU as on the card), or a
    tensor or numpy array: copied chunk by chunk when it lies off
    ``device`` (default: the tensor's own device), else sliced with no copy
    and no accounting. ``aux`` follows the same rule.
    """
    if isinstance(x, ChunkStore):
        src, dev, host, store_chunk = x.x, x.device, True, x.chunk
    else:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        dev = torch.device(device) if device is not None else x.device
        src, host, store_chunk = x, x.device != dev, None
    if isinstance(aux, np.ndarray):
        aux = torch.from_numpy(np.ascontiguousarray(aux))
    aux_host = aux is not None and _is_host(aux, dev)
    c = max(1, int(chunk) if chunk is not None else (store_chunk or default_chunk(dev)))
    n = src.shape[0]
    slices = [slice(i, min(i + c, n)) for i in range(0, n, c)]
    if not slices:
        return
    cuda = dev.type == "cuda" and (host or aux_host)
    consumer = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(device=dev) if cuda else None

    def copy(a: Tensor) -> Tensor:
        if not cuda:
            return a.to(dev)
        with torch.cuda.stream(side):
            return a.to(dev, non_blocking=True)

    def put(sl):
        xb = copy(src[sl]) if host else src[sl]
        ab = None if aux is None else (copy(aux[sl]) if aux_host else aux[sl])
        if host:
            _TRACKER.add(_nbytes(xb))
        if aux_host:
            _TRACKER.add(_nbytes(ab))
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(side)
        return xb, ab, event

    def ready(item):
        xb, ab, event = item
        if event is not None:
            consumer.wait_event(event)
            for t in (xb, ab):
                if t is not None and t.device.type == "cuda":
                    t.record_stream(consumer)
        return xb, ab

    def drop(item):
        xb, ab, _ = item
        if host:
            _TRACKER.sub(_nbytes(xb))
        if aux_host:
            _TRACKER.sub(_nbytes(ab))

    cur = put(slices[0])
    for sl in slices[1:]:
        nxt = put(sl)  # the copy of chunk i+1 is issued before chunk i runs
        yield ready(cur)
        drop(cur)
        cur = nxt
    yield ready(cur)
    drop(cur)
