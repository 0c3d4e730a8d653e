"""sklearn-style estimators over the paper's solvers — the second slot.

The counterpart of ``repro.api.estimators``: ``FalkonRegressor``,
``FalkonClassifier`` (one-vs-rest as one multi-RHS solve),
``NystromRegressor`` and ``ExactKrr``. The sampler slot defaults to
``BlessSampler()``, so ``FalkonRegressor()`` is FALKON-BLESS:

    est = FalkonRegressor(kernel="gaussian", sigma=4.0,
                          sampler=BlessSampler(lam=1e-4, m_cap=10_000),
                          config=FitConfig(lam=1e-6, iters=20))
    est.fit(X, y)          # -> est  (learned attrs get a trailing underscore)
    est.predict(X)         # (n,) or (n, k), through the backend seam
    est.score(X, y)        # R^2 (uniform average over outputs)

The estimators run on the card: ``FitConfig.device`` defaults to "cuda",
where the contractions are the CUDA kernels, and raise ``RuntimeError`` when
no CUDA device is present. ``FitConfig(device="cpu")`` asks for the plain
torch path (``TorchBackend``). Inputs (tensors or numpy arrays) are moved to
the configured device as float32; a ``ChunkStore`` stays in host memory and
streams (``backend="stream:cuda"``, or the default past
``REPRO_STREAM_MIN_ROWS`` rows).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.backend import Backend, backend_for_device, require_cuda_device
from ..core.falkon import FalkonModel, falkon_fit
from ..core.gram import BackendLike, Kernel, make_kernel, resolve_backend
from ..core.leverage import CenterSet
from ..core.nystrom import exact_krr, nystrom_krr
from ..stream import ChunkStore, StreamBackend
from .samplers import BlessSampler, Sampler

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Solver configuration shared by every estimator.

    Attributes:
      lam: the solver's ridge regularization (the paper's lambda).
      iters: CG iteration count (FALKON only).
      backend: kernel-operator backend — instance, registry name ("torch" |
        "cuda" | "sharded" | "guarded" | ...), or None for the device's
        backend (CUDA kernels on "cuda", the plain torch streamer on "cpu").
        On a graph-safe backend (``TorchBackend``) the fit takes the fused
        path (``falkon_fit(fused=None)``): refits and sweep columns in one
        shape bucket reuse one plan.
      seed: sampler seed when ``fit`` is not given one.
      check_finite: arm the finite-output fence on FALKON fits (one host
        sync per fit; the direct solvers are always fenced).
      device: where the data and the solve live; "cuda" (default) or "cpu".
    """

    lam: float = 1e-3
    iters: int = 20
    backend: BackendLike = None
    seed: int = 0
    check_finite: bool = False
    device: str = "cuda"


def _as_kernel(kernel: Kernel | str, sigma: float) -> Kernel:
    return kernel if isinstance(kernel, Kernel) else make_kernel(kernel, sigma=sigma)


class _KrrEstimator:
    """Shared fit bookkeeping + predict/score for the estimators."""

    def __init__(self, kernel: Kernel | str = "gaussian", *, sigma: float = 1.0,
                 config: FitConfig | None = None):
        self.kernel = _as_kernel(kernel, sigma)
        self.config = config if config is not None else FitConfig()
        self.model_: FalkonModel | None = None

    def _device(self) -> torch.device:
        return require_cuda_device(self.config.device)

    def _backend(self, x=None) -> Backend:
        """The configured backend, else the device's (on each rank's rows,
        ``ShardedBackend``, in a process group of more than one rank from
        ``SHARD_MIN_ROWS`` rows); a ``ChunkStore`` input streams through
        ``StreamBackend`` around the device's backend."""
        if self.config.backend is not None:
            return resolve_backend(self.config.backend)
        if isinstance(x, ChunkStore):
            return StreamBackend(inner=backend_for_device(self._device()))
        return backend_for_device(self._device(),
                                  n=x.shape[0] if isinstance(x, Tensor) else None)

    def _as_data(self, a) -> Tensor | ChunkStore:
        """A tensor on the configured device; a host-resident ``ChunkStore``
        passes through untouched, so the streaming paths keep X out of
        device memory."""
        if isinstance(a, ChunkStore):
            return a
        return torch.as_tensor(a, dtype=torch.float32, device=self._device())

    def predict(self, x, *, return_std: bool = False) -> Tensor | tuple[Tensor, Tensor]:
        """Predictions through the backend seam ((n,) or (n, k)).

        With ``return_std=True`` returns ``(pred, std)``, ``std`` the (n,)
        square root of ``predictive_variance`` (the seam's ``rls_scores``:
        on the card K5 up to 1024 centers, K1 + K6 above).
        """
        if self.model_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted; call .fit first")
        pred = self.model_.predict(self._as_data(x), backend=self._backend(x))
        if not return_std:
            return pred
        return pred, torch.sqrt(self.predictive_variance(x))

    def predictive_variance(self, x) -> Tensor:
        """GP-style posterior variance per row of ``x`` ((n,), nonnegative)."""
        if self.model_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted; call .fit first")
        return self.model_.predictive_variance(self._as_data(x), backend=self._backend(x))

    def score(self, x, y) -> float:
        """Coefficient of determination R^2 (uniform average over outputs)."""
        y = self._as_data(y)
        pred = self.predict(x)
        if y.shape != pred.shape:
            raise ValueError(f"y has shape {tuple(y.shape)} but the model predicts "
                             f"{tuple(pred.shape)}")
        res = torch.sum((y - pred) ** 2, dim=0)
        tot = torch.clamp(torch.sum((y - torch.mean(y, dim=0)) ** 2, dim=0), min=1e-30)
        return float(torch.mean(1.0 - res / tot))

    def _seed(self, key: int | torch.Generator | None) -> int | torch.Generator:
        return self.config.seed if key is None else key


class FalkonRegressor(_KrrEstimator):
    """FALKON (Sec. 3) with a pluggable center sampler.

    ``sampler`` fills the pipeline's first slot (defaults to
    ``BlessSampler()``, i.e. FALKON-BLESS); the sampled ``CenterSet``'s
    weights become the preconditioner's A (Def. 2). ``warm_start=True``
    keeps the sampled centers across refits on same-shaped X.
    """

    def __init__(self, kernel: Kernel | str = "gaussian", *,
                 sampler: Sampler | None = None, sigma: float = 1.0,
                 config: FitConfig | None = None, warm_start: bool = False):
        super().__init__(kernel, sigma=sigma, config=config)
        self.sampler = sampler if sampler is not None else BlessSampler()
        self.warm_start = warm_start
        self.centers_: Tensor | None = None
        self.a_diag_: Tensor | None = None
        self.center_set_: CenterSet | None = None
        self._fit_shape_: tuple | None = None

    def fit(self, x, y, *, key: int | torch.Generator | None = None,
            center_set: CenterSet | None = None,
            callback: Callable[[int, FalkonModel], None] | None = None,
            row_mask=None) -> "FalkonRegressor":
        """Sample centers (unless warm-starting) and solve by preconditioned
        CG. ``center_set`` bypasses the sampler with a precomputed (J, A);
        ``callback(i, model)`` is called after every CG iteration
        (single-output only); ``row_mask`` (shaped like y) gives each column
        its own training rows (on the card through K7)."""
        x = self._as_data(x)
        y = self._as_data(y)
        cfg = self.config
        backend = self._backend(x)
        reuse = (center_set is None and self.warm_start and self.centers_ is not None
                 and self._fit_shape_ == tuple(x.shape))
        if not reuse:
            cs = center_set if center_set is not None else self.sampler.sample(
                self._seed(key), x, self.kernel, backend=backend)
            m = int(cs.count)
            self.center_set_ = cs
            self.centers_ = x[cs.idx[:m].to(x.device)]
            self.a_diag_ = cs.weight[:m].to(device=x.device, dtype=torch.float32)
            self._fit_shape_ = tuple(x.shape)
        self.model_ = falkon_fit(self.kernel, x, y, self.centers_, cfg.lam,
                                 a_diag=self.a_diag_, iters=cfg.iters, backend=backend,
                                 callback=callback, check_finite=cfg.check_finite,
                                 row_mask=None if row_mask is None else self._as_data(row_mask))
        return self


def _host_labels(y) -> np.ndarray:
    """Labels as a host numpy array (a tensor on any device, or array-like)."""
    return y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


class FalkonClassifier(FalkonRegressor):
    """One-vs-rest classification as ONE multi-RHS FALKON solve.

    The k classes become k right-hand-side columns of a single block-CG on
    shared centers (squared loss on +-1 one-hot targets, the least-squares
    SVM reading): the preconditioner and every K_nM sweep are paid once, so
    k classes cost the k-output regression, not k fits.

    ``predict`` returns labels from ``self.classes_`` (argmax of the margin
    panel); ``decision_function`` gives the raw (n, k) margins (K4 on the
    card); ``predict_proba`` is a softmax over the margins, a monotone
    calibration, not a fitted probability model; ``score`` is accuracy.
    Binary problems keep both columns (k = 2), so every class has a margin.
    """

    #: sorted unique training labels; set by ``fit``.
    classes_: np.ndarray | None = None

    def fit(self, x, y, *, key: int | torch.Generator | None = None,
            center_set: CenterSet | None = None,
            callback: Callable[[int, FalkonModel], None] | None = None,
            row_mask=None) -> "FalkonClassifier":
        """Encode the labels as a +-1 one-hot panel and fit the multi-RHS solve.

        ``y`` is (n,) labels of any dtype numpy can sort (ints, strings, ...);
        the sorted unique labels become ``self.classes_``. ``callback`` is
        refused (the panel fit has no single-output host loop).
        """
        if callback is not None:
            raise ValueError("FalkonClassifier fits a multi-RHS panel; "
                             "per-iteration callback is single-output only")
        labels = _host_labels(y)
        if labels.ndim != 1:
            raise ValueError(f"classifier targets must be (n,) labels, "
                             f"got shape {labels.shape}")
        classes, inv = np.unique(labels, return_inverse=True)
        if classes.shape[0] < 2:
            raise ValueError("need at least 2 classes to classify")
        self.classes_ = classes
        inv = torch.as_tensor(inv.reshape(-1), device=self._device())
        cols = torch.arange(classes.shape[0], device=inv.device)
        panel = torch.where(inv[:, None] == cols[None, :], 1.0, -1.0).to(torch.float32)
        super().fit(x, panel, key=key, center_set=center_set, row_mask=row_mask)
        return self

    def decision_function(self, x) -> Tensor:
        """Raw one-vs-rest margins (n, k) through the panel predict."""
        return super().predict(x)

    def predict(self, x, *, return_std: bool = False):
        """Predicted labels (n,) from ``classes_[argmax(margins)]``; with
        ``return_std=True`` also the (n,) posterior std of the margins."""
        margins = self.decision_function(x)
        labels = self.classes_[torch.argmax(margins, dim=1).cpu().numpy()]
        if not return_std:
            return labels
        return labels, torch.sqrt(self.predictive_variance(x))

    def predict_proba(self, x) -> Tensor:
        """Softmax over the margins, (n, k) rows summing to 1: a monotone
        score calibration (ranking-faithful), not fitted probabilities."""
        return torch.softmax(self.decision_function(x), dim=1)

    def score(self, x, y) -> float:
        """Classification accuracy in [0, 1]."""
        return float(np.mean(self.predict(x) == _host_labels(y)))


class NystromRegressor(_KrrEstimator):
    """Direct Nystrom-KRR (Def. 4) on sampled centers — the O(n M^2) dense
    solve FALKON's CG converges to."""

    def __init__(self, kernel: Kernel | str = "gaussian", *,
                 sampler: Sampler | None = None, sigma: float = 1.0,
                 config: FitConfig | None = None):
        super().__init__(kernel, sigma=sigma, config=config)
        self.sampler = sampler if sampler is not None else BlessSampler()
        self.centers_: Tensor | None = None
        self.center_set_: CenterSet | None = None

    def fit(self, x, y, *, key: int | torch.Generator | None = None) -> "NystromRegressor":
        """Sample centers and solve Def. 4 directly; ``y`` (n,) or (n, k)."""
        x = self._as_data(x)
        backend = self._backend(x)
        cs = self.sampler.sample(self._seed(key), x, self.kernel, backend=backend)
        m = int(cs.count)
        self.center_set_ = cs
        self.centers_ = x[cs.idx[:m].to(x.device)]
        self.model_ = nystrom_krr(self.kernel, x, self._as_data(y), self.centers_,
                                  self.config.lam, backend=backend)
        return self


class ExactKrr(_KrrEstimator):
    """Exact kernel ridge regression (Eq. 12) — the O(n^3) oracle."""

    def fit(self, x, y, *, key: int | torch.Generator | None = None) -> "ExactKrr":
        """Solve Eq. 12 on the full Gram matrix; ``y`` (n,) or (n, k). A
        ``ChunkStore`` is brought to the device whole: materializing is the
        algorithm here."""
        x = x.to_device() if isinstance(x, ChunkStore) else x
        self.model_ = exact_krr(self.kernel, self._as_data(x), self._as_data(y),
                                self.config.lam, backend=self._backend())
        return self


__all__ = ["FitConfig", "FalkonRegressor", "FalkonClassifier", "NystromRegressor",
           "ExactKrr"]
