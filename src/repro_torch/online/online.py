"""Online FALKON: incremental appends, warm refits, background center
refresh (DESIGN.md §11).

The PyTorch counterpart of ``repro.online.online``. ``OnlineFalkon`` keeps
the streamed normal-equation accumulators H = K_nM^T K_nM, b = K_nM^T y
live between fits. Appended rows are copied to the host ``ChunkStore``
and folded into (H, b) in O(batch), and a warm refit solves
(H + lam n K_MM) alpha = b in O(M^2 iters), independent of n.

Ingest fence (always on): appended rows pass ``health.check_finite``
before they touch the store or the accumulators, so a NaN row is rejected
with the state untouched. The ``online.corrupt_row`` injection point
poisons a row (of a clone of the batch) upstream of the fence.

Center refresh: ``refresh_centers`` re-draws the center set with any
sampler that has the ``Sampler`` protocol's ``.sample`` and rebuilds
(H, b) against it in one streamed pass. With ``background=True`` the
rebuild runs in a worker thread over a snapshot row count, launching its
kernels on that thread's current stream (the default stream), while the
foreground keeps appending; ``join_refresh`` absorbs the rows appended
meanwhile and swaps the new state in.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from ..core import health
from ..core.falkon import FalkonModel
from ..core.gram import BackendLike, Kernel, resolve_backend
from ..stream.store import ChunkStore
from ..testing import faults
from .accumulate import ACC_DTYPE, absorb, solve_accumulators

Tensor = torch.Tensor


class OnlineFalkon:
    """Incrementally updatable FALKON over a growing ``ChunkStore``.

    Args:
      kernel: the ``repro_torch.core.gram.Kernel``.
      centers: initial (M, d) center set.
      lam: ridge regularization (scaled by the current n at each refit).
      x, y: the seed batch; ``x`` may be a ``ChunkStore`` already carrying
        y (else a store is built on ``device``). Absorbed at construction.
      a_diag: sampler weights diag(A) for the preconditioner (None = I).
      iters: CG iterations per refit.
      backend: tile-builder spec ("stream" = K1 on the card,
        "stream:torch", an instance, or None for the device's default);
        also recorded on the fitted model for serving.
      sampler: optional default sampler for ``refresh_centers``.
      chunk: rows per chunk of a store built here.
      device: the device of a store built here ("cuda" or "cpu").

    Attributes:
      model_: the latest refitted ``FalkonModel`` (None before ``refit``).
      counters: appends / rows / rejected / refits / refreshes.
    """

    def __init__(self, kernel: Kernel, centers, lam: float, *, x, y=None,
                 a_diag=None, iters: int = 20, backend: BackendLike = "stream",
                 sampler=None, chunk: int | None = None,
                 device: torch.device | str = "cuda"):
        self.kernel = kernel
        self.lam = float(lam)
        self.iters = int(iters)
        self.sampler = sampler
        if isinstance(x, ChunkStore):
            if x.y is None:
                raise ValueError("OnlineFalkon needs targets; build the ChunkStore with y")
            self.store = x
        else:
            if y is None:
                raise ValueError("OnlineFalkon needs targets y")
            self.store = ChunkStore(x, y, chunk=chunk, device=device)
        dev = self.store.device
        self.backend = resolve_backend(backend, device=dev, n=self.store.shape[0])
        self._inner = getattr(self.backend, "inner", self.backend)
        self.centers = torch.as_tensor(centers, dtype=torch.float32).to(dev)
        m = self.centers.shape[0]
        if self.centers.ndim != 2 or self.centers.shape[1] != self.store.shape[1]:
            raise ValueError(f"centers must be (M, {self.store.shape[1]}), "
                             f"got {tuple(self.centers.shape)}")
        self.a_diag = (None if a_diag is None
                       else torch.as_tensor(a_diag, dtype=torch.float32).to(dev))
        self._k_shape = tuple(self.store.y.shape[1:])
        h = torch.zeros((m, m), dtype=ACC_DTYPE, device=dev)
        b = torch.zeros((m,) + self._k_shape, dtype=ACC_DTYPE, device=dev)
        self._h, self._b = absorb(self.kernel, self.store.x, self.store.y, self.centers,
                                  h, b, inner=self._inner, chunk=self.store.chunk)
        self.model_: Optional[FalkonModel] = None
        self.counters = {"appends": 0, "rows": int(self.store.shape[0]),
                         "rejected": 0, "refits": 0, "refreshes": 0}
        self._refresh_thread: Optional[threading.Thread] = None
        self._refresh_result: Optional[tuple] = None
        self._refresh_error: Optional[BaseException] = None

    # -- ingest ---------------------------------------------------------------

    def append(self, x_new, y_new) -> int:
        """Absorb a batch of rows; returns the new total row count.

        A batch carrying NaN/Inf raises ``health.NonFiniteError`` with the
        store and the accumulators untouched; rejections are counted and
        logged to the health event log.
        """
        x_new = torch.as_tensor(x_new, dtype=torch.float32)
        y_new = torch.as_tensor(y_new, dtype=torch.float32)
        d = self.store.shape[1]
        if x_new.ndim != 2 or x_new.shape[1] != d or x_new.shape[0] == 0:
            raise ValueError(f"append batch must be non-empty (r, {d}), "
                             f"got {tuple(x_new.shape)}")
        if y_new.shape[0] != x_new.shape[0] or tuple(y_new.shape[1:]) != self._k_shape:
            raise ValueError(f"append targets {tuple(y_new.shape)} do not match x rows "
                             f"{x_new.shape[0]} and output shape {self._k_shape}")
        if faults.active():  # chaos: poison a row upstream of the fence
            x_new = faults.corrupt("online.corrupt_row", x_new)
        try:
            health.check_finite(x_new, "online append X")
            health.check_finite(y_new, "online append y")
        except health.NonFiniteError:
            self.counters["rejected"] += 1
            health.record_event("online_append_rejected", rows=int(x_new.shape[0]))
            raise
        xh, yh = x_new.cpu(), y_new.cpu()
        self.store.append(xh, yh)
        self._h, self._b = absorb(self.kernel, xh, yh, self.centers, self._h, self._b,
                                  inner=self._inner, chunk=self.store.chunk)
        self.counters["appends"] += 1
        self.counters["rows"] = int(self.store.shape[0])
        return self.counters["rows"]

    # -- refit ----------------------------------------------------------------

    def refit(self) -> FalkonModel:
        """Warm refit from the live accumulators: O(M^2 iters), no data pass.
        Returns (and stores) the new model."""
        n = self.store.shape[0]
        alpha, resid = solve_accumulators(self.kernel, self._h, self._b, self.centers,
                                          self.lam, n, a_diag=self.a_diag, iters=self.iters,
                                          backend=self._inner)
        m = self.centers.shape[0]
        self.model_ = FalkonModel(
            centers=self.centers, alpha=alpha, kernel=self.kernel, backend=self.backend,
            diagnostics=health.SolveDiagnostics(resid), lam=self.lam, n_train=n,
            a_diag=(torch.ones((m,), dtype=torch.float32, device=self.centers.device)
                    if self.a_diag is None else self.a_diag))
        self.counters["refits"] += 1
        return self.model_

    # -- center refresh --------------------------------------------------------

    def _build_refresh(self, key, sampler, n_snapshot: int):
        """Draw new centers and rebuild (H, b) over rows [0, n_snapshot)."""
        cs = sampler.sample(key, self.store, self.kernel, backend=self.backend)
        m = int(cs.count)
        dev = self.store.device
        centers = self.store[cs.idx[:m]]
        a_diag = cs.weight[:m].to(device=dev, dtype=torch.float32)
        h = torch.zeros((m, m), dtype=ACC_DTYPE, device=dev)
        b = torch.zeros((m,) + self._k_shape, dtype=ACC_DTYPE, device=dev)
        h, b = absorb(self.kernel, self.store.x[:n_snapshot], self.store.y[:n_snapshot],
                      centers, h, b, inner=self._inner, chunk=self.store.chunk)
        return centers, a_diag, h, b, n_snapshot

    def _install_refresh(self, result) -> None:
        """Swap refreshed state in, absorbing the rows appended since the
        snapshot against the new centers first."""
        centers, a_diag, h, b, n_snapshot = result
        n_now = self.store.shape[0]
        if n_now > n_snapshot:
            h, b = absorb(self.kernel, self.store.x[n_snapshot:n_now],
                          self.store.y[n_snapshot:n_now], centers, h, b,
                          inner=self._inner, chunk=self.store.chunk)
        self.centers, self.a_diag = centers, a_diag
        self._h, self._b = h, b
        self.counters["refreshes"] += 1
        health.record_event("online_center_refresh", m=int(centers.shape[0]), rows=n_now)

    def refresh_centers(self, key, *, sampler=None, background: bool = False) -> None:
        """Re-draw the center set and rebuild the accumulators against it.

        ``sampler`` (or the constructor default) is any object with
        ``.sample(key, x, kernel, backend=...)``. Inline by default; with
        ``background=True`` the sampling and rebuild run in a worker thread
        over the current rows while appends continue against the old state;
        ``join_refresh`` absorbs the delta and swaps.
        """
        sampler = sampler if sampler is not None else self.sampler
        if sampler is None:
            raise ValueError("refresh_centers needs a sampler (argument or "
                             "constructor default)")
        if self._refresh_thread is not None:
            raise RuntimeError("a background refresh is already running; "
                               "join_refresh() it first")
        n_snapshot = self.store.shape[0]
        if not background:
            self._install_refresh(self._build_refresh(key, sampler, n_snapshot))
            return

        def _work():
            try:
                self._refresh_result = self._build_refresh(key, sampler, n_snapshot)
            except BaseException as e:  # noqa: BLE001 — re-raised by join_refresh
                self._refresh_error = e

        self._refresh_thread = threading.Thread(target=_work, daemon=True)
        self._refresh_thread.start()

    def join_refresh(self) -> bool:
        """Wait for a background refresh and install it (delta absorbed).
        Returns True if one was installed, False if none was running;
        re-raises the worker's error (the old state stays live)."""
        if self._refresh_thread is None:
            return False
        self._refresh_thread.join()
        self._refresh_thread = None
        err, self._refresh_error = self._refresh_error, None
        result, self._refresh_result = self._refresh_result, None
        if err is not None:
            raise err
        self._install_refresh(result)
        return True
