"""Named fault-injection points for the chaos paths (DESIGN.md §9).

The PyTorch counterpart of ``repro.testing.faults``, with the same points,
parameters and firing rules. Production modules host tiny hooks at their
dispatch boundaries::

    if faults.active():                      # one dict emptiness check
        faults.raise_if("backend.error")
        out = faults.corrupt("gram.nan_tile", out)

With no fault armed, ``active()`` is a single module-level dict check, paid
once per host-level dispatch (never per element). This module imports
nothing of the package, so any layer can host a hook without an import
cycle.

Injection points (the registry rejects unknown names):

  ``gram.nan_tile``     NaN written into a just-computed Gram/predict tile
                        (params: ``rows``, how many leading rows to poison,
                        default 1).
  ``backend.error``     raise ``FaultInjected`` at kernel dispatch.
  ``dispatch.latency``  artificial per-dispatch latency (params:
                        ``seconds``, a float or a callable
                        ``(rows, centers) -> float``; ``advance``, a
                        virtual-clock hook called instead of sleeping).
  ``kmm.indefinite``    shift a K_MM-like matrix indefinite before its
                        factorization (params: ``shift``, multiples of the
                        mean diagonal subtracted, default 2.0).
  ``ckpt.torn_write``   kill ``save_checkpoint`` mid-write; the hook fires
                        at every filesystem step (params: ``stage``, fire
                        only at that named step, e.g. ``"pre_rename"``, the
                        torn window between the complete temp dir and the
                        atomic rename; None = every step).
  ``online.corrupt_row``  poison a row of a batch appended to
                        ``OnlineFalkon`` with NaN (params: ``row``, default
                        0), upstream of the finite-input fence.

Arming is scoped by the ``fault`` context manager; ``times=N`` makes a
fault fire on the first N hook hits then go inert, and ``skip=K`` makes it
sit out the first K matching hits before firing.

``corrupt`` never writes into its argument: it returns a corrupted clone,
so a poisoned batch or K_MM never reaches the caller's own tensor.

``FaultyBackend`` wraps any kernel-operator backend with every hook;
``VirtualClock`` is a deterministic clock for serving simulations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterator

import torch

#: The known injection points; ``fault()`` rejects anything else so a typo
#: cannot silently arm nothing.
POINTS = frozenset({
    "gram.nan_tile",
    "backend.error",
    "dispatch.latency",
    "kmm.indefinite",
    "ckpt.torn_write",
    "online.corrupt_row",
})


class FaultInjected(RuntimeError):
    """The error raised by an armed ``backend.error`` injection point."""


@dataclasses.dataclass
class Fault:
    """One armed fault: its point, firing window, and parameters.

    ``seen`` counts every matching hook hit (after any ``stage`` filter),
    whether or not the fault fired; ``skip`` holds the fault inert for the
    first ``skip`` matching hits.
    """

    point: str
    times: int | None = None  # fire at most N times; None = every hit
    skip: int = 0  # sit out the first K matching hits
    params: dict = dataclasses.field(default_factory=dict)
    fired: int = 0
    seen: int = 0

    @property
    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times


_ACTIVE: dict[str, Fault] = {}


def active() -> bool:
    """True iff any fault is armed: the happy-path fast check."""
    return bool(_ACTIVE)


@contextlib.contextmanager
def fault(point: str, *, times: int | None = None, skip: int = 0,
          **params: Any) -> Iterator[Fault]:
    """Arm ``point`` for the duration of the context; yields the Fault."""
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: {sorted(POINTS)}")
    if point in _ACTIVE:
        raise RuntimeError(f"fault point {point!r} is already armed")
    f = Fault(point=point, times=times, skip=skip, params=params)
    _ACTIVE[point] = f
    try:
        yield f
    finally:
        _ACTIVE.pop(point, None)


def _take(point: str, tag: str | None = None) -> Fault | None:
    """Consume one firing of ``point`` if armed and inside its window.
    ``tag`` names the hook site; a fault armed with a ``stage`` parameter
    matches only that tag."""
    if not _ACTIVE:
        return None
    f = _ACTIVE.get(point)
    if f is None:
        return None
    stage = f.params.get("stage")
    if stage is not None and tag is not None and stage != tag:
        return None
    f.seen += 1
    if f.seen <= f.skip or f.exhausted:
        return None
    f.fired += 1
    return f


# -- hook functions (called from production dispatch sites) -----------------


def raise_if(point: str = "backend.error", *, tag: str | None = None) -> None:
    """Raise ``FaultInjected`` if ``point`` is armed (dispatch-failure hook)."""
    f = _take(point, tag)
    if f is not None:
        raise FaultInjected(
            f"injected fault at {point!r}"
            + (f" stage {tag!r}" if tag is not None else "")
            + f" (firing {f.fired})")


def sleep_if(point: str = "dispatch.latency", *, rows: int = 0, centers: int = 0) -> None:
    """Apply armed per-dispatch latency: ``time.sleep``, or a virtual-clock
    advance when the fault carries an ``advance`` hook."""
    f = _take(point)
    if f is None:
        return
    seconds = f.params.get("seconds", 0.0)
    if callable(seconds):
        seconds = seconds(rows, centers)
    advance = f.params.get("advance")
    if advance is not None:
        advance(seconds)
    elif seconds > 0:
        time.sleep(seconds)


def corrupt(point: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` corrupted per the armed fault at ``point`` (a clone), or ``x``
    itself when nothing fires.

    ``gram.nan_tile`` poisons the first ``rows`` rows (default 1) with NaN;
    ``kmm.indefinite`` subtracts ``shift`` x the mean diagonal from the
    diagonal; ``online.corrupt_row`` sets row ``row`` (default 0) to NaN.
    """
    f = _take(point)
    if f is None:
        return x
    if point == "gram.nan_tile":
        out = x.clone()
        out[: int(f.params.get("rows", 1))] = float("nan")
        return out
    if point == "kmm.indefinite":
        scale = float(f.params.get("shift", 2.0)) * torch.mean(torch.diagonal(x))
        return x - scale * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    if point == "online.corrupt_row":
        out = x.clone()
        out[int(f.params.get("row", 0))] = float("nan")
        return out
    raise ValueError(f"{point!r} is not a corruption point")


# ---------------------------------------------------------------------------
# Backend wrapper + virtual clock
# ---------------------------------------------------------------------------


class FaultyBackend:
    """A kernel-operator backend wrapper with every injection point armed.

    Duck-typed against the ``Backend`` seam; unknown attributes delegate to
    the wrapped backend.
    """

    name = "faulty"
    #: its hooks run on the host at every dispatch, so a fused fit, which
    #: dispatches nothing, would pass them by
    graph_safe = False

    def __init__(self, inner):
        self.inner = inner

    def _pre(self, rows: int = 0, centers: int = 0) -> None:
        if active():
            sleep_if(rows=rows, centers=centers)
            raise_if()

    def gram_block(self, kernel, x, z):
        """K(X, Z) through the hooks."""
        self._pre(x.shape[0], z.shape[0])
        out = self.inner.gram_block(kernel, x, z)
        return corrupt("gram.nan_tile", out) if active() else out

    def masked_quadform(self, kernel, x_cand, z, mask, reg):
        """Eq. 3 quadratic form through the hooks."""
        self._pre(x_cand.shape[0], z.shape[0])
        return self.inner.masked_quadform(kernel, x_cand, z, mask, reg)

    def rls_scores(self, kernel, x_cand, z, z_mask, reg, lamn):
        """Eq. 3 scores through the hooks."""
        self._pre(x_cand.shape[0], z.shape[0])
        return self.inner.rls_scores(kernel, x_cand, z, z_mask, reg, lamn)

    def knm_quadratic(self, kernel, x, z, *, mask=None):
        """CG quadratic op whose every call passes through the hooks."""
        inner_op = self.inner.knm_quadratic(kernel, x, z, mask=mask)

        def op(v):
            self._pre(x.shape[0], z.shape[0])
            return inner_op(v)

        return op

    def knm_t(self, kernel, x, z, y, *, mask=None):
        """K_nM^T y through the hooks."""
        self._pre(x.shape[0], z.shape[0])
        return self.inner.knm_t(kernel, x, z, y, mask=mask)

    def knm_operators(self, kernel, x, z, y, *, mask=None):
        """(quadratic op, K_nM^T y) with both legs hooked."""
        return (self.knm_quadratic(kernel, x, z, mask=mask),
                self.knm_t(kernel, x, z, y, mask=mask))

    def knm_matvec(self, kernel, x, z, v):
        """K(X, Z) v through the hooks (the serving dispatch)."""
        self._pre(x.shape[0], z.shape[0])
        out = self.inner.knm_matvec(kernel, x, z, v)
        return corrupt("gram.nan_tile", out) if active() else out

    def __getattr__(self, item):
        return getattr(self.inner, item)


@dataclasses.dataclass
class VirtualClock:
    """A deterministic manual clock: call it for "now", ``advance`` to move."""

    t: float = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        """Move the clock forward by ``dt`` seconds (must be >= 0)."""
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self.t += dt
