"""Serving-grade batched KRR prediction: micro-batching over
``FalkonModel.predict`` with padded pow2 row buckets (DESIGN.md §4).

The PyTorch counterpart of ``repro.serving.krr``. Pending requests are
packed into waves of at most ``max_wave`` rows; each wave is zero-padded up
to a power-of-two row bucket (never below ``min_bucket``), moved to the
model's device once, and served by one ``knm_matvec`` dispatch through the
``Backend`` seam (K4 on the card). Torch keeps no compile cache per shape,
but the buckets still bound the shapes K4 sees to
``log2(max_wave / min_bucket) + 1`` and keep the ``stats`` the reference
reports.

Requests arrive from the host: ``submit`` checks them there (shape, the
finite fence) and keeps them in host memory, so the fence costs no device
sync per request.

    server = KrrServer(FalkonRegressor(...).fit(x, y))
    rid = server.submit(x_req)        # queue a (r, d) request
    preds = server.flush()            # {rid: (r,) or (r, k) predictions}
    server.predict(x)                 # submit + flush convenience
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Tuple, Union

import torch

from ..core import health
from ..core.falkon import FalkonModel
from ..core.gram import BackendLike

Tensor = torch.Tensor


def pow2_bucket(rows: int, min_bucket: int) -> int:
    """Smallest power of two >= rows, floored at min_bucket."""
    return max(min_bucket, 1 << max(0, rows - 1).bit_length())


def unwrap_model(model) -> FalkonModel:
    """A ``FalkonModel`` as is, or a fitted ``repro_torch.api`` estimator's
    ``model_``; raises ``ValueError`` on an unfitted estimator."""
    if hasattr(model, "centers"):
        return model
    inner = getattr(model, "model_", None)
    if inner is None:
        raise ValueError(f"{type(model).__name__} has no fitted model; "
                         "call .fit before serving it")
    return inner


def host_request(x, d: int, max_rows: int | None = None) -> Tensor:
    """A request as a host fp32 (r, d) tensor, or ``ValueError`` when it is
    malformed, larger than ``max_rows`` or not finite (a NaN row would
    poison every request packed into its wave)."""
    x = torch.as_tensor(x, dtype=torch.float32).cpu()
    if x.ndim != 2 or x.shape[0] == 0 or x.shape[1] != d:
        raise ValueError(f"request must be a non-empty (r, {d}) array, got {tuple(x.shape)}")
    if max_rows is not None and x.shape[0] > max_rows:
        raise ValueError(f"request rows {x.shape[0]} exceed max_wave {max_rows}")
    finite = torch.isfinite(x)
    if not bool(torch.all(finite)):
        raise ValueError(f"request contains non-finite values ({int(torch.sum(~finite))} of "
                         f"{x.numel()}); refusing to pack it into a shared wave")
    return x


def padded_wave(xs: List[Tensor], bucket: int, device: torch.device) -> Tensor:
    """The host requests ``xs`` stacked and zero-padded to ``bucket`` rows,
    moved to ``device`` in one copy."""
    rows = sum(x.shape[0] for x in xs)
    pad = xs[0].new_zeros((bucket - rows, xs[0].shape[1]))
    return torch.cat(xs + [pad]).to(device)


def probe_model(model, probe_x=None, *, backend: BackendLike = None) -> FalkonModel:
    """Pre-swap health probe (DESIGN.md §11): the unwrapped model, or raises.

    The candidate's alpha must be finite (``health.NonFiniteError``), and so
    must its predictions on a probe batch, by default a prefix of its own
    centers. ``ValueError`` on an unfitted estimator.
    """
    mdl = unwrap_model(model)
    health.check_finite(mdl.alpha, "swap candidate alpha")
    if probe_x is None:
        probe_x = mdl.centers[: min(8, mdl.centers.shape[0])]
    probe_x = torch.as_tensor(probe_x, dtype=torch.float32).to(mdl.centers.device)
    health.check_finite(mdl.predict(probe_x, backend=backend), "swap candidate probe predictions")
    return mdl


@dataclasses.dataclass
class KrrServer:
    """Micro-batching front end over one FALKON/KRR model.

    Attributes:
      model: a ``FalkonModel`` or a fitted ``repro_torch.api`` estimator
        (its ``model_`` is unwrapped); prediction runs through its backend.
      backend: per-server override of the model's fit-time backend.
      max_wave: row budget per dispatch (a single larger request still goes
        out alone, padded to its own pow2 bucket).
      min_bucket: smallest padded bucket.
      clock: monotonic-seconds callable stamping swap provenance.

    ``stats``: requests, rows, dispatches, padded_rows, buckets (the set of
    padded shapes), and the model provenance: swaps / swaps_rejected,
    model_version (0 = the construction-time model) and last_swap (clock
    time of the latest accepted swap; None = never). ``reset()`` wipes them.
    """

    model: Union[FalkonModel, object]
    backend: BackendLike = None
    max_wave: int = 4096
    min_bucket: int = 64
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.max_wave < 1 or self.min_bucket < 1:
            raise ValueError("max_wave and min_bucket must be positive")
        self.model = unwrap_model(self.model)
        self.reset()

    def reset(self) -> None:
        """Drop queued requests and zero the counters."""
        self._queue: Deque[Tuple[int, Tensor]] = collections.deque()
        self._next_rid = 0
        self._pending_rows = 0
        self.stats = {"requests": 0, "rows": 0, "dispatches": 0,
                      "padded_rows": 0, "buckets": set(), "swaps": 0,
                      "swaps_rejected": 0, "model_version": 0,
                      "last_swap": None}

    def swap_model(self, model, *, probe_x=None) -> bool:
        """Swap the served model after a ``probe_model`` health fence.

        True on success (provenance stats updated), False if the probe
        rejected the candidate (the current model keeps serving).
        ``ValueError`` (unfitted estimator, feature-dim mismatch) propagates.
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
        self.model = mdl
        self.stats["swaps"] += 1
        self.stats["model_version"] += 1
        self.stats["last_swap"] = float(self.clock())
        health.record_event("model_swap", version=self.stats["model_version"])
        return True

    def submit(self, x) -> int:
        """Queue a (r, d) request; returns its id (see flush)."""
        x = host_request(x, self.model.centers.shape[1])
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, x))
        self._pending_rows += x.shape[0]
        self.stats["requests"] += 1
        self.stats["rows"] += x.shape[0]
        return rid

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    def flush(self) -> Dict[int, Tensor]:
        """Serve every queued request; returns {request id: predictions}."""
        out: Dict[int, Tensor] = {}
        while self._queue:
            wave: List[Tuple[int, Tensor]] = [self._queue.popleft()]
            rows = wave[0][1].shape[0]
            # pack until the row budget: a request never splits across waves
            while self._queue and rows + self._queue[0][1].shape[0] <= self.max_wave:
                rid, x = self._queue.popleft()
                wave.append((rid, x))
                rows += x.shape[0]
            self._pending_rows -= rows
            bucket = pow2_bucket(rows, self.min_bucket)
            xp = padded_wave([x for _, x in wave], bucket, self.model.centers.device)
            pred = self.model.predict(xp, backend=self.backend)
            self.stats["dispatches"] += 1
            self.stats["padded_rows"] += bucket - rows
            self.stats["buckets"].add(bucket)
            off = 0
            for rid, x in wave:
                out[rid] = pred[off:off + x.shape[0]]
                off += x.shape[0]
        return out

    def predict(self, x) -> Tensor:
        """One-shot convenience: submit + flush a single request."""
        rid = self.submit(x)
        return self.flush()[rid]
