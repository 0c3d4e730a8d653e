"""Fault-tolerant async continuous-batching KRR serving (DESIGN.md §9).

The PyTorch counterpart of ``repro.serving.async_krr``. ``AsyncKrrServer``
keeps ``KrrServer``'s pow2 wave packing and wraps it in a serving loop with
explicit failure domains:

  * **Bounded queue + backpressure.** ``submit`` rejects (``QueueFull``)
    or sheds the oldest queued request (``overflow="shed_oldest"``) once
    ``max_queue_rows`` is exceeded.
  * **Per-request deadlines.** A request whose deadline passes while
    queued is EXPIRED at pack time.
  * **Slot recycling.** Up to ``max_inflight`` waves are in flight at
    once: ``step()`` fills free slots from the queue, then completes the
    oldest wave, so the card computes while the host packs.
  * **Wave-level failure isolation.** A wave that fails (a dispatch error
    or non-finite outputs caught by the fence) is retried split in half,
    recursively; a singleton that still fails marks only that request
    FAILED.
  * **Graceful degradation.** When the rolling p99 wave latency breaches
    ``slo``, the server switches to ``fallback_model`` until p99 recovers
    below ``recover_factor * slo``.
  * **Zero-downtime model swaps.** ``swap_model`` replaces the served model
    behind a health probe, atomic at wave granularity; every request is
    tagged with the generation that served it.

Device semantics. A wave's ``predict`` returns once its kernels are
queued; ``_dispatch`` then records a ``torch.cuda.Event`` on the current
stream, and ``_complete`` waits on it (``event.synchronize()``) before the
finite fence reads the outputs. Wave latency is the host clock from
dispatch to completion. A launch error that the kernel wrapper raises
(``C10_CUDA_KERNEL_LAUNCH_CHECK``) is a wave failure like any other and
goes through split-retry. A sticky CUDA error (an illegal address, say)
poisons the whole context: no later wave can run, so it cannot be
isolated, and this server does not try to handle it.

Deterministic tests drive this with ``repro_torch.testing.faults`` and
``VirtualClock`` via the ``clock=`` hook.

    server = AsyncKrrServer(model, config=ServeConfig(slo=0.05))
    rid = server.submit(x_req, deadline=clock() + 0.2)
    server.run_until_idle()
    server.result(rid)        # Tensor | None; server.status(rid) says why
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..core import health
from ..core.falkon import FalkonModel
from ..core.gram import BackendLike
from .krr import host_request, padded_wave, pow2_bucket, probe_model, unwrap_model

Tensor = torch.Tensor

#: swap_model sentinel: "leave the fallback model alone" (None clears it).
_KEEP = object()


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the queue is full and ``overflow="reject"``."""


class RequestStatus(enum.Enum):
    """Lifecycle of a request inside ``AsyncKrrServer``."""

    QUEUED = "queued"
    IN_FLIGHT = "in_flight"
    DONE = "done"
    FAILED = "failed"
    EXPIRED = "expired"
    SHED = "shed"


@dataclasses.dataclass
class Request:
    """One queued prediction request and its serving metadata."""

    rid: int
    x: Tensor  # host (r, d) fp32
    submitted: float
    deadline: Optional[float] = None
    status: RequestStatus = RequestStatus.QUEUED
    result: Optional[Tensor] = None
    error: Optional[str] = None
    #: stats["model_version"] at dispatch time: the model generation that
    #: served this request (None until dispatched).
    model_version: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-loop policy knobs for ``AsyncKrrServer``.

    Attributes:
      max_wave: row budget per dispatch (requests never split).
      min_bucket: smallest pow2 padding bucket.
      max_queue_rows: queued-row bound; None = unbounded.
      overflow: ``"reject"`` raises ``QueueFull`` at the bound;
        ``"shed_oldest"`` drops the oldest queued request (SHED).
      deadline: default per-request deadline in seconds after submit.
      slo: target p99 wave latency in seconds (None disables degradation).
      slo_window: rolling window of wave latencies for the p99.
      recover_factor: leave degraded mode when p99 < recover_factor * slo.
      check_finite: fence every completed wave's outputs.
      max_inflight: wave slots kept in flight before completion is forced.
    """

    max_wave: int = 4096
    min_bucket: int = 64
    max_queue_rows: Optional[int] = None
    overflow: str = "reject"
    deadline: Optional[float] = None
    slo: Optional[float] = None
    slo_window: int = 64
    recover_factor: float = 0.5
    check_finite: bool = True
    max_inflight: int = 2

    def __post_init__(self):
        if self.max_wave < 1 or self.min_bucket < 1 or self.max_inflight < 1:
            raise ValueError("max_wave, min_bucket, max_inflight must be positive")
        if self.overflow not in ("reject", "shed_oldest"):
            raise ValueError(f"overflow must be 'reject' or 'shed_oldest', "
                             f"got {self.overflow!r}")
        if not 0.0 < self.recover_factor <= 1.0:
            raise ValueError("recover_factor must be in (0, 1]")


@dataclasses.dataclass
class _Wave:
    """One in-flight dispatch: its requests, the padded prediction and the
    event recorded after its kernels (None off the card)."""

    requests: List[Request]
    rows: int
    pred: Optional[Tensor]
    started: float
    degraded: bool
    version: int = 0
    event: Optional[torch.cuda.Event] = None


class AsyncKrrServer:
    """Fault-tolerant continuous-batching server over one (or two) models.

    Args:
      model: primary ``FalkonModel`` or fitted ``repro_torch.api`` estimator.
      fallback_model: cheaper model served while degraded (optional).
      config: the ``ServeConfig`` policy bundle.
      backend: per-server override of the model's fit-time backend.
      clock: monotonic-seconds callable; inject ``VirtualClock`` in tests.
    """

    def __init__(self, model, *, fallback_model=None,
                 config: ServeConfig = ServeConfig(),
                 backend: BackendLike = None,
                 clock: Callable[[], float] = time.monotonic):
        self.model = unwrap_model(model)
        self.fallback_model = None if fallback_model is None else unwrap_model(fallback_model)
        d = self.model.centers.shape[1]
        if self.fallback_model is not None and self.fallback_model.centers.shape[1] != d:
            raise ValueError("fallback model feature dim "
                             f"{self.fallback_model.centers.shape[1]} != {d}")
        self.config = config
        self.backend = backend
        self.clock = clock
        self.degraded = False
        self._queue: Deque[Request] = collections.deque()
        self._queued_rows = 0
        self._inflight: Deque[_Wave] = collections.deque()
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._latencies: Deque[float] = collections.deque(maxlen=config.slo_window)
        self.stats = {"requests": 0, "rows": 0, "dispatches": 0,
                      "padded_rows": 0, "buckets": set(), "wave_failures": 0,
                      "splits": 0, "shed": 0, "expired": 0, "failed": 0,
                      "degraded_waves": 0, "swaps": 0, "swaps_rejected": 0,
                      "model_version": 0, "last_swap": None}

    # -- intake --------------------------------------------------------------

    def submit(self, x, *, deadline: Optional[float] = None) -> int:
        """Queue a (r, d) request; returns its id.

        Raises ``ValueError`` on malformed or non-finite input and
        ``QueueFull`` under backpressure with the ``"reject"`` policy.
        ``deadline`` is an absolute clock time; defaults to
        ``config.deadline`` seconds from now.
        """
        x = host_request(x, self.model.centers.shape[1], self.config.max_wave)
        cap = self.config.max_queue_rows
        if cap is not None:
            while self._queued_rows + x.shape[0] > cap:
                if self.config.overflow == "reject" or not self._queue:
                    raise QueueFull(f"queue at {self._queued_rows} rows (cap {cap})")
                victim = self._queue.popleft()
                self._queued_rows -= victim.x.shape[0]
                victim.status = RequestStatus.SHED
                victim.error = "shed under queue pressure"
                self.stats["shed"] += 1
        now = self.clock()
        if deadline is None and self.config.deadline is not None:
            deadline = now + self.config.deadline
        req = Request(rid=self._next_rid, x=x, submitted=now, deadline=deadline)
        self._next_rid += 1
        self._queue.append(req)
        self._queued_rows += x.shape[0]
        self._requests[req.rid] = req
        self.stats["requests"] += 1
        self.stats["rows"] += x.shape[0]
        return req.rid

    # -- model lifecycle -----------------------------------------------------

    def swap_model(self, model, *, fallback_model=_KEEP, probe_x=None) -> bool:
        """Zero-downtime model swap, atomic at wave granularity.

        The model is read once per wave at dispatch, so waves in flight
        complete on the old model and every wave packed after this call
        predicts with the new one. The candidate first passes
        ``probe_model``; a poisoned candidate is rejected (False,
        ``swaps_rejected`` counts it, the incumbent keeps serving).
        ``fallback_model`` optionally replaces the degraded-mode model (None
        clears it; omitted keeps it). ``ValueError`` propagates.
        """
        try:
            mdl = probe_model(model, probe_x, backend=self.backend)
        except ValueError:
            raise
        except Exception as e:  # noqa: BLE001 — a failing probe IS the signal
            self.stats["swaps_rejected"] += 1
            health.record_event("swap_rejected", error=repr(e))
            return False
        d = self.model.centers.shape[1]
        if mdl.centers.shape[1] != d:
            raise ValueError(f"swap candidate feature dim {mdl.centers.shape[1]} != {d}")
        if fallback_model is not _KEEP:
            fb = None if fallback_model is None else unwrap_model(fallback_model)
            if fb is not None and fb.centers.shape[1] != d:
                raise ValueError(f"fallback model feature dim {fb.centers.shape[1]} != {d}")
            self.fallback_model = fb
        self.model = mdl
        self.stats["swaps"] += 1
        self.stats["model_version"] += 1
        self.stats["last_swap"] = float(self.clock())
        health.record_event("model_swap", version=self.stats["model_version"])
        return True

    # -- serving loop --------------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: fill free wave slots, then complete the
        oldest in-flight wave. Returns True if any work remains."""
        while self._queue and len(self._inflight) < self.config.max_inflight:
            if not self._dispatch_next():
                break
        if self._inflight:
            self._complete(self._inflight.popleft())
        return bool(self._queue or self._inflight)

    def run_until_idle(self) -> None:
        """Drive ``step`` until the queue and all wave slots are empty."""
        while self.step():
            pass

    def result(self, rid: int) -> Optional[Tensor]:
        """The (r,) / (r, k) prediction for ``rid``, or None if not DONE."""
        return self._requests[rid].result

    def status(self, rid: int) -> RequestStatus:
        """Lifecycle state of ``rid`` (why ``result`` may be None)."""
        return self._requests[rid].status

    def p99_latency(self) -> Optional[float]:
        """Rolling p99 of wave latencies (None until a wave completed)."""
        if not self._latencies:
            return None
        return float(np.percentile(np.asarray(self._latencies), 99))

    # -- internals -----------------------------------------------------------

    def _pack(self) -> List[Request]:
        """Pop a wave's worth of live requests (expiring stale ones)."""
        now = self.clock()
        wave: List[Request] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if nxt.deadline is not None and now > nxt.deadline:
                self._queue.popleft()
                self._queued_rows -= nxt.x.shape[0]
                nxt.status = RequestStatus.EXPIRED
                nxt.error = "deadline passed while queued"
                self.stats["expired"] += 1
                continue
            if wave and rows + nxt.x.shape[0] > self.config.max_wave:
                break
            self._queue.popleft()
            self._queued_rows -= nxt.x.shape[0]
            wave.append(nxt)
            rows += nxt.x.shape[0]
        return wave

    def _serving_model(self) -> FalkonModel:
        if self.degraded and self.fallback_model is not None:
            return self.fallback_model
        return self.model

    def _dispatch_next(self) -> bool:
        """Pack and dispatch one wave; False if the queue yielded nothing."""
        wave = self._pack()
        if not wave:
            return False
        self._dispatch(wave)
        return True

    def _dispatch(self, wave: List[Request]) -> bool:
        """Dispatch one wave. True if it went in flight; False if dispatch
        itself raised (the failure was already isolated)."""
        rows = sum(r.x.shape[0] for r in wave)
        bucket = pow2_bucket(rows, self.config.min_bucket)
        model = self._serving_model()
        degraded = model is not self.model
        started = self.clock()
        self.stats["dispatches"] += 1
        self.stats["padded_rows"] += bucket - rows
        self.stats["buckets"].add(bucket)
        if degraded:
            self.stats["degraded_waves"] += 1
        version = self.stats["model_version"]
        for r in wave:
            r.status = RequestStatus.IN_FLIGHT
            r.model_version = version
        try:
            xp = padded_wave([r.x for r in wave], bucket, model.centers.device)
            pred = model.predict(xp, backend=self.backend)
        except Exception as e:  # noqa: BLE001 — isolated, never propagated
            self._wave_failed(_Wave(requests=wave, rows=rows, pred=None, started=started,
                                    degraded=degraded, version=version), e)
            return False
        event = None
        if pred.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(pred.device))
        self._inflight.append(_Wave(requests=wave, rows=rows, pred=pred, started=started,
                                    degraded=degraded, version=version, event=event))
        return True

    def _complete(self, wave: _Wave) -> None:
        """Wait for a wave; scatter results or isolate the failure."""
        try:
            if wave.event is not None:
                wave.event.synchronize()
            pred = wave.pred
            if self.config.check_finite:
                finite = torch.isfinite(pred[:wave.rows])
                if not bool(torch.all(finite)):
                    raise health.NonFiniteError(
                        f"wave of {len(wave.requests)} requests produced "
                        f"{int(torch.sum(~finite))} non-finite outputs")
        except Exception as e:  # noqa: BLE001 — any wave failure is isolated
            self._wave_failed(wave, e)
            return
        latency = self.clock() - wave.started
        off = 0
        for r in wave.requests:
            r.result = pred[off:off + r.x.shape[0]]
            off += r.x.shape[0]
            r.status = RequestStatus.DONE
        self._latencies.append(latency)
        self._update_slo()

    def _wave_failed(self, wave: _Wave, err: Exception) -> None:
        """Isolate a failed wave: retry split in half, recursively; a
        singleton that still fails takes down only its own request."""
        self.stats["wave_failures"] += 1
        health.record_event("wave_failure", requests=len(wave.requests),
                            rows=wave.rows, error=repr(err))
        if len(wave.requests) == 1:
            req = wave.requests[0]
            req.status = RequestStatus.FAILED
            req.error = repr(err)
            self.stats["failed"] += 1
            return
        mid = len(wave.requests) // 2
        self.stats["splits"] += 1
        for half in (wave.requests[:mid], wave.requests[mid:]):
            # retries complete at once (pop() = the wave just dispatched, not
            # the FIFO head), so a persistent fault bottoms out to singletons
            # before new traffic packs in
            if self._dispatch(half):
                self._complete(self._inflight.pop())

    def _update_slo(self) -> None:
        cfg = self.config
        if cfg.slo is None or self.fallback_model is None:
            return
        p99 = self.p99_latency()
        if p99 is None:
            return
        if not self.degraded and p99 > cfg.slo:
            self.degraded = True
            health.record_event("slo_degrade", p99=p99, slo=cfg.slo)
        elif self.degraded and p99 < cfg.recover_factor * cfg.slo:
            self.degraded = False
            health.record_event("slo_recover", p99=p99, slo=cfg.slo)


__all__ = ["AsyncKrrServer", "ServeConfig", "Request", "RequestStatus", "QueueFull"]
