"""Fault tolerance & straggler mitigation for the training loop.

The port keeps its own copy of ``repro.runtime.monitor`` (plain Python; the
port imports nothing of the reference). The checkpointer it drives is
``repro_torch.checkpoint.AsyncCheckpointer`` or anything with its ``save``
and ``wait``.

HeartbeatMonitor: per-step wall-time tracking; a step slower than
``threshold x`` the running median flags a straggler (at real multi-pod
scale the hook triggers data-bucket redistribution / hot-spare swap; here
it is surfaced to the loop + logs, and is unit-tested with injected delays).

FaultTolerantLoop: checkpoint-restart supervision around a step function —
catches worker exceptions, restores the latest checkpoint, replays the
deterministic data pipeline from the restored step (data needs no state:
batches are a pure function of step), and resumes. The last step is
checkpointed once: the reference writes it a second time when it falls on
``ckpt_every``.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Any, Callable, Optional

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class HeartbeatMonitor:
    threshold: float = 2.5
    window: int = 32
    _durations: list[float] = dataclasses.field(default_factory=list)
    stragglers: list[tuple[int, float]] = dataclasses.field(default_factory=list)

    def record(self, step: int, duration: float) -> bool:
        """Returns True if this step is a straggler."""
        hist = self._durations[-self.window:]
        self._durations.append(duration)
        if len(hist) < 8:
            return False
        med = statistics.median(hist)
        if duration > self.threshold * med:
            self.stragglers.append((step, duration))
            log.warning("straggler: step %d took %.3fs (median %.3fs)", step, duration, med)
            return True
        return False

    @property
    def median(self) -> float:
        return statistics.median(self._durations) if self._durations else 0.0


class FaultTolerantLoop:
    """Supervised train loop: step -> heartbeat -> periodic async checkpoint;
    on failure restore + replay. ``failure_injector`` lets tests kill steps."""

    def __init__(self, step_fn: Callable[[Any, int], tuple[Any, dict]],
                 checkpointer, *, ckpt_every: int = 50,
                 monitor: Optional[HeartbeatMonitor] = None,
                 max_restarts: int = 3,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.checkpointer = checkpointer
        self.ckpt_every = ckpt_every
        self.monitor = monitor or HeartbeatMonitor()
        self.max_restarts = max_restarts
        self.failure_injector = failure_injector
        self.restarts = 0

    def run(self, state: Any, start_step: int, num_steps: int,
            restore_fn: Callable[[], tuple[int, Any]]) -> tuple[Any, int]:
        step = start_step
        while step < start_step + num_steps:
            try:
                t0 = time.perf_counter()
                if self.failure_injector is not None:
                    self.failure_injector(step)
                state, metrics = self.step_fn(state, step)
                self.monitor.record(step, time.perf_counter() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.checkpointer.save(step, state)
            except Exception as e:  # noqa: BLE001 — supervision boundary
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring latest checkpoint", step, e)
                step, state = restore_fn()
        if not (step > start_step and step % self.ckpt_every == 0):  # else just written
            self.checkpointer.save(step, state)
        self.checkpointer.wait()
        return state, step
