"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``). Each
returns None where its cell gives it nothing to read."""
from __future__ import annotations

import statistics


def span_mean(view, entry: str, part: str):
    """Mean host seconds of one part of a traced job (``Job.spans``)."""
    values = [j.spans[part] for j in view.jobs if part in j.spans]
    return statistics.fmean(values) if view.entry == entry and values else None


def roofline(view, span: str):
    """Percent: the least seconds of the work priced under ``span`` (a
    ``pb.<seam call>``) over the device seconds of the operations launched
    inside the spans ``span``."""
    if view.trace is None:
        return None
    least = sum(p[span].least_s() for p in view.prices if span in p)
    device_s = view.trace.span_device_s(span)
    return 100.0 * least / device_s if device_s > 0 and least > 0 else None


def device_idle(view, entry: str):
    """Percent of the traced window in which the device ran no operation."""
    if view.entry != entry or view.trace is None:
        return None
    return 100.0 * (1.0 - view.trace.busy_s() / view.trace.window_s())


def mfu(view, entry: str):
    """Percent: the least seconds of the counted work at the chip's peaks of
    the jobs run after the profiler stopped (untraced, as without
    ``--trace``), over those jobs' host seconds."""
    if view.entry != entry or not view.rest_prices or view.rest_s <= 0:
        return None
    return 100.0 * sum(p["job"].least_s() for p in view.rest_prices) / view.rest_s
