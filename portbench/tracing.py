"""Spans around the calls into each layer, the profiler over a traced window,
and what the per-layer readers take from its trace.

``span_backend`` wraps the seam (``CudaBackend``) and opens a
``record_function`` span named ``pb.<method>`` around every call into it; a
CG application of K_nM^T (K_nM v) is ``pb.knm_quadratic`` (with a row mask
``pb.knm_quadratic_masked``). It adds spans only: the same calls reach the
same kernels. ``Trace`` reads the profiler's Chrome trace: the device's
operations, the host's events on the thread that ran the window, and which
span each device operation was launched in.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
from typing import ClassVar

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .jobs import program

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
#: host calls that launch device work: the runtime's and the driver's
#: (``cuLaunchKernel``, which libraries may call directly)
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "pb.window"
#: idle gaps named by what the host was doing, longest first
NAMED_GAPS = 2000


def span_backend(inner):
    """``inner`` with a ``pb.<method>`` span around every call into it."""
    base = program()["Backend"]

    @dataclasses.dataclass(frozen=True)
    class SpanBackend(base):
        name: ClassVar[str] = "spans"

        def gram_block(self, kernel, x, z):
            with record_function("pb.gram_block"):
                return inner.gram_block(kernel, x, z)

        def masked_quadform(self, kernel, x_cand, z, mask, reg):
            with record_function("pb.masked_quadform"):
                return inner.masked_quadform(kernel, x_cand, z, mask, reg)

        def rls_scores(self, kernel, x_cand, z, z_mask, reg, lamn):
            with record_function("pb.rls_scores"):
                return inner.rls_scores(kernel, x_cand, z, z_mask, reg, lamn)

        def knm_quadratic(self, kernel, x, z, *, mask=None):
            op = inner.knm_quadratic(kernel, x, z, mask=mask)
            label = "pb.knm_quadratic" if mask is None else "pb.knm_quadratic_masked"

            def traced(v):
                with record_function(label):
                    return op(v)

            return traced

        def knm_t(self, kernel, x, z, y, *, mask=None):
            with record_function("pb.knm_t"):
                return inner.knm_t(kernel, x, z, y, mask=mask)

        def knm_matvec(self, kernel, x, z, v):
            with record_function("pb.knm_matvec"):
                return inner.knm_matvec(kernel, x, z, v)

    return SpanBackend()


def profiler(device: torch.device):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)


@dataclasses.dataclass(frozen=True)
class Event:
    ts: float  # microseconds
    end: float
    name: str


class Trace:
    """A traced window: device operations, the window thread's host events,
    and the host span each device operation was launched in."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW} span")
        w = win[0]
        self.window = Event(float(w["ts"]), float(w["ts"]) + float(w["dur"]), WINDOW)
        tid = w.get("tid")
        launch_ts = {}
        host = []
        self.device: list[tuple[Event, object]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((Event(ts, ts + dur, e.get("name", "?")),
                                    e.get("args", {}).get("correlation")))
            elif cat in HOST_CATS:
                if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                    launch_ts[e["args"]["correlation"]] = ts
                if e.get("tid") == tid:
                    host.append(Event(ts, ts + dur, e.get("name", "?")))
        self.device.sort(key=lambda p: p[0].ts)
        self.launch_ts = launch_ts
        self.host = sorted(host, key=lambda e: (e.ts, -e.end))

    @classmethod
    def of(cls, prof) -> "Trace":
        """Export the stopped profiler's Chrome trace to a temporary file and read it."""
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return cls(events)

    def window_s(self) -> float:
        return (self.window.end - self.window.ts) * 1e-6

    def _busy(self) -> list[list[float]]:
        """Merged intervals in which the device ran an operation, inside the window."""
        merged: list[list[float]] = []
        for ev, _ in self.device:
            a, b = max(ev.ts, self.window.ts), min(ev.end, self.window.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside host spans ``name``."""
        spans = [e for e in self.host if e.name == name]
        starts = [e.ts for e in spans]
        total = 0.0
        for ev, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i].end:
                total += ev.end - ev.ts
        return total * 1e-6

    def coverage(self) -> tuple[float, float]:
        """(device seconds inside the window of the operations whose launch
        was recorded, device seconds of all operations inside it): the first
        is what the spans can attribute."""
        launched = total = 0.0
        for ev, corr in self.device:
            s = max(0.0, min(ev.end, self.window.end) - max(ev.ts, self.window.ts))
            total += s
            launched += s if corr in self.launch_ts else 0.0
        return launched * 1e-6, total * 1e-6

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten things
        the host was doing (the innermost ``pb.`` span / the innermost host
        event) in the longest idle gaps of the device, in seconds."""
        ops = collections.Counter()
        for ev, _ in self.device:
            ops[ev.name[:120]] += (ev.end - ev.ts) * 1e-6
        busy = self._busy()
        edges = [self.window.ts] + [v for iv in busy for v in iv] + [self.window.end]
        gaps = sorted(((edges[i + 1] - edges[i], (edges[i] + edges[i + 1]) / 2)
                       for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
        named = collections.Counter()
        chosen = sorted(gaps[:NAMED_GAPS], key=lambda g: g[1])
        stack: list[Event] = []
        k = 0
        for length, mid in chosen:
            while k < len(self.host) and self.host[k].ts <= mid:
                while stack and stack[-1].end <= self.host[k].ts:
                    stack.pop()
                stack.append(self.host[k])
                k += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            spans = [e.name for e in stack if e.name.startswith("pb.")]
            inner = stack[-1].name if stack else "python"
            where = spans[-1] if spans else "python"
            named[where if inner == where else f"{where} / {inner}"] += length * 1e-6
        return {"device_ops": [[k_, v] for k_, v in ops.most_common(10)],
                "idle_gaps": [[k_, v] for k_, v in named.most_common(10)]}
