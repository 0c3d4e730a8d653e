"""Numerical health fences for the solver stack.

The PyTorch counterpart of ``repro.core.health``:

  * **Factorization** — ``chol_with_jitter_ladder`` factors ``a + eps0 10^k I``
    for k = 0 .. JITTER_LEVELS-1 (eps0 trace-scaled) and reports the level
    used; ``safe_cholesky`` returns a finite factor or raises
    ``FactorizationError``, never a silent NaN. Both use
    ``torch.linalg.cholesky_ex``, which reports failure without raising.
  * **Iteration** — ``SolveDiagnostics`` classifies a CG residual trajectory
    (converged / stalled / diverged) lazily on host access.
  * **Outputs** — ``check_finite`` raises ``NonFiniteError`` instead of
    letting a NaN through.

Recoveries are appended to a bounded in-process event log (``record_event``
/ ``events`` / ``clear_events``).
"""
from __future__ import annotations

import collections
from typing import Any, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class HealthError(RuntimeError):
    """Base class for solver/serving health-fence failures."""


class FactorizationError(HealthError):
    """A Cholesky factorization failed through the whole jitter ladder."""


class NonFiniteError(HealthError):
    """A finite-output fence caught NaN/Inf at a layer boundary."""


#: Ladder length: attempt k uses jitter eps0 * 10^k with eps0 = 1e-6 * the
#: mean diagonal, so the last level adds ~10x the mean diagonal.
JITTER_LEVELS = 8


def chol_with_jitter_ladder(a: Tensor) -> tuple[Tensor, int]:
    """Cholesky with escalating trace-scaled jitter; returns (chol, level).

    Attempt ``k`` factors ``a + eps0 * 10^k * I`` (``eps0 = 1e-6 * mean
    diag``); the ladder stops at the first attempt that succeeds. If every
    level fails, the factor comes back as NaN with ``level ==
    JITTER_LEVELS - 1`` — the fences (``safe_cholesky``, ``check_finite``)
    own the raise. One host sync per attempt.
    """
    eps0 = torch.clamp(1e-6 * torch.mean(torch.diagonal(a)), min=1e-30)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    for level in range(JITTER_LEVELS):
        chol, info = torch.linalg.cholesky_ex(a + eps0 * (10.0 ** level) * eye)
        if int(info) == 0 and bool(torch.all(torch.isfinite(chol))):
            return chol, level
    return torch.full_like(a, float("nan")), JITTER_LEVELS - 1


def safe_cholesky(a: Tensor, *, what: str = "matrix") -> tuple[Tensor, int]:
    """The ladder with the fence armed: a finite factor or raise.

    Returns ``(chol, level)``; raises ``FactorizationError`` if the whole
    ladder failed. Escalations (level > 0) go to the event log.
    """
    chol, level = chol_with_jitter_ladder(a)
    if not bool(torch.all(torch.isfinite(chol))):
        record_event("factorization_failure", what=what, level=level)
        raise FactorizationError(
            f"Cholesky of {what} ({a.shape[0]}x{a.shape[1]}) stayed non-finite "
            f"after {JITTER_LEVELS} escalating jitter levels (up to ~10x the "
            "mean diagonal); the matrix is not numerically PSD")
    if level > 0:
        record_event("jitter_escalation", what=what, level=level)
    return chol, level


def check_finite(x: Tensor, what: str = "array") -> Tensor:
    """Boundary fence: return ``x`` unchanged or raise ``NonFiniteError``."""
    finite = torch.isfinite(x)
    if not bool(torch.all(finite)):
        bad = int(torch.sum(~finite))
        record_event("non_finite", what=what, bad=bad)
        raise NonFiniteError(
            f"{what} contains {bad} non-finite value(s) "
            f"(shape {tuple(x.shape)}); refusing to propagate")
    return x


# ---------------------------------------------------------------------------
# CG residual-trajectory diagnostics
# ---------------------------------------------------------------------------

#: A residual above this factor over its initial value means the "SPD"
#: operator/preconditioner pair is broken.
DIVERGENCE_FACTOR = 1e2
#: Converged: squared residual reduced below this fraction of the initial.
CONVERGED_REL = 1e-8
#: Stalled: the second half of the run improved the squared residual by less
#: than this factor while still far from converged.
STALL_IMPROVEMENT = 0.5


class SolveDiagnostics(NamedTuple):
    """Residual-trajectory health report for one CG solve.

    ``residuals`` holds the squared preconditioned-residual norms, (iters+1,)
    for one right-hand side or (iters+1, k) for a panel (row 0 = initial).
    The properties fetch to the host on first access.
    """

    residuals: Tensor

    def _np(self) -> np.ndarray:
        r = self.residuals.detach().to("cpu", torch.float64).numpy()
        return r[:, None] if r.ndim == 1 else r

    @property
    def reduction(self) -> np.ndarray:
        """Per-column final/initial squared-residual ratio, shape (k,)."""
        r = self._np()
        return r[-1] / np.maximum(r[0], 1e-300)

    @property
    def converged(self) -> bool:
        """Every column reduced its squared residual below CONVERGED_REL."""
        return bool(np.all(self.reduction < CONVERGED_REL))

    @property
    def diverged(self) -> bool:
        """Some column's residual blew past DIVERGENCE_FACTOR x initial."""
        r = self._np()
        return bool(np.any(np.max(r, axis=0) > DIVERGENCE_FACTOR * np.maximum(r[0], 1e-300)))

    @property
    def stalled(self) -> bool:
        """Some column made < STALL_IMPROVEMENT progress over the second half
        of the run while still unconverged (and did not diverge)."""
        if self.diverged:
            return False
        r = self._np()
        mid = r[r.shape[0] // 2]
        tail = r[-1] / np.maximum(mid, 1e-300)
        unconverged = self.reduction >= CONVERGED_REL
        return bool(np.any(unconverged & (tail > STALL_IMPROVEMENT)))

    def summary(self) -> str:
        """One-line verdict (fetches the residuals)."""
        state = ("diverged" if self.diverged else
                 "converged" if self.converged else
                 "stalled" if self.stalled else "progressing")
        worst = float(np.max(self.reduction))
        return (f"cg {state}: {self.residuals.shape[0] - 1} iters, "
                f"worst residual reduction {worst:.3e}")


# ---------------------------------------------------------------------------
# Health event log
# ---------------------------------------------------------------------------

_EVENTS: collections.deque = collections.deque(maxlen=512)


def record_event(kind: str, **info: Any) -> None:
    """Append a recovery/failure event to the bounded in-process log."""
    _EVENTS.append({"kind": kind, **info})


def events(kind: str | None = None) -> list[dict]:
    """Snapshot of recorded events, optionally filtered by ``kind``."""
    return [e for e in _EVENTS if kind is None or e["kind"] == kind]


def clear_events() -> None:
    """Drop all recorded events."""
    _EVENTS.clear()
