"""Cross-validated model selection as multi-RHS solves — the third slot.

The counterpart of ``repro.api.sweep``. ``KFoldSweep`` turns the "k folds x
L lambdas = k L fits" grid into L multi-RHS FALKON solves: the k folds
become k columns of ONE block-CG (``repro_torch.core.falkon``), sharing the
sampled centers, the preconditioner and every K_nM sweep.

Fold semantics, exact row exclusion: column f solves the system a separate
refit on the fold-f training rows would solve,

    (K_nM^T diag(m_f) K_nM + lam n_f K_MM) alpha_f = K_nM^T (m_f * y),

where m_f masks out fold f's rows and n_f = sum(m_f). The masks ride the
seam as an (n, folds) ``row_mask`` panel: on the card the quadratic op is
the row-masked kernel K7, so held-out rows add nothing to fold f's
operator. The shared preconditioner keeps the global n while a refit
builds its own with n_f, so the two agree at convergence, not iterate by
iterate: compare a sweep with naive refits at converged iteration counts.
The sweep leaves ``fused`` to ``falkon_fit``: on a graph-safe backend
(``TorchBackend``) every λ after the first reuses the bucket's fused plan.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.backend import require_cuda_device
from ..core.gram import BackendLike, Kernel
from ..core.leverage import CenterSet
from ..core.sampling import as_generator
from .estimators import FalkonRegressor, FitConfig
from .samplers import BlessSampler, Sampler

Tensor = torch.Tensor


def fold_ids(key: int | torch.Generator, n: int, folds: int) -> Tensor:
    """Random balanced fold assignment: (n,) int32 in [0, folds), on the CPU.

    A random permutation (``torch.randperm`` on a CPU generator) dealt
    round-robin, so fold sizes differ by at most one row. The deal is a
    scatter with unique indices: no order-dependent sum is involved.
    """
    perm = torch.randperm(n, generator=as_generator(key))
    deal = torch.remainder(torch.arange(n, dtype=torch.int32), folds)
    return torch.empty((n,), dtype=torch.int32).scatter_(0, perm, deal)


def split_generators(key: int | torch.Generator) -> tuple[torch.Generator, torch.Generator]:
    """Two independent CPU generators derived from one seed: (centers, folds).

    The fold generator is seeded apart from the sampler's, so the fold
    assignment does not depend on whether the sampler runs."""
    seeds = torch.randint(0, 2 ** 62, (2,), generator=as_generator(key))
    return tuple(torch.Generator(device="cpu").manual_seed(int(s)) for s in seeds)


@dataclasses.dataclass(frozen=True)
class KFoldResult:
    """Scores of one ``KFoldSweep.run``.

    Attributes:
      lams: the swept regularization grid, in run order.
      scores: (len(lams), folds) fp32 — held-out MSE of fold f's column at
        each lambda (column f is scored only on rows assigned to fold f).
      fold_id: (n,) int32 fold assignment used, for reproducing splits.
      center_set: the shared sampled ``CenterSet`` every solve rode on.
    """

    lams: tuple[float, ...]
    scores: Tensor
    fold_id: Tensor
    center_set: CenterSet

    @property
    def mean_scores(self) -> Tensor:
        """(len(lams),) — per-lambda MSE averaged over folds."""
        return torch.mean(self.scores, dim=1)

    @property
    def best_index(self) -> int:
        """Index into ``lams`` with the lowest mean held-out MSE."""
        return int(torch.argmin(self.mean_scores))

    @property
    def best_lam(self) -> float:
        """The selected regularization: ``lams[best_index]``."""
        return self.lams[self.best_index]


@dataclasses.dataclass
class KFoldSweep:
    """Exact k-fold lambda selection where folds are columns of one solve.

    One sampler call picks the shared centers; then each lambda costs a
    single multi-RHS fit (folds = RHS columns, each excluding its held-out
    rows through the ``row_mask`` panel) plus one panel predict, against
    ``folds * len(lams)`` fits for the naive grid.

    Attributes:
      kernel: a ``Kernel`` or a registered family name ("gaussian", ...).
      sampler: center sampler (slot 1); default ``BlessSampler()``.
      lams: regularization grid for the solver (the paper's lam_falkon).
      folds: number of cross-validation folds (= RHS columns per solve).
      sigma: bandwidth when ``kernel`` is given by name.
      iters: CG iterations per solve.
      backend: kernel-operator backend spec (instance, name, or None).
      seed: seed of the center sample and the fold assignment when ``run``
        gets no explicit key.
      device: where the data and the solves live, as ``FitConfig.device``:
        "cuda" (default; raises without a card) or "cpu".

    Example::

        sweep = KFoldSweep(kernel="gaussian", sigma=2.0,
                           lams=(1e-3, 1e-5, 1e-7), folds=5)
        res = sweep.run(x, y)
        best = res.best_lam            # lowest mean held-out MSE
    """

    kernel: Kernel | str = "gaussian"
    sampler: Sampler | None = None
    lams: Sequence[float] = (1e-3, 1e-5, 1e-7)
    folds: int = 5
    sigma: float = 1.0
    iters: int = 20
    backend: BackendLike = None
    seed: int = 0
    device: str = "cuda"

    def run(self, x, y, *, key: int | torch.Generator | None = None,
            center_set: CenterSet | None = None) -> KFoldResult:
        """Sweep the lambda grid; returns per-fold, per-lambda held-out MSE.

        ``x`` (n, d) and single-output ``y`` (n,), tensors or arrays, moved to
        ``device`` as fp32; ``center_set`` bypasses the sampler with a
        precomputed (J, A). The centers and the folds are drawn from two
        generators derived from ``key`` (default ``seed``).
        """
        device = require_cuda_device(self.device)
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = torch.as_tensor(y, dtype=torch.float32, device=device)
        if y.ndim != 1:
            raise ValueError(f"KFoldSweep needs single-output y (n,), got {tuple(y.shape)}; "
                             "the fold columns occupy the RHS axis")
        if not 2 <= self.folds <= y.shape[0]:
            raise ValueError(f"folds must be in [2, n], got {self.folds}")
        g_sample, g_fold = split_generators(self.seed if key is None else key)
        fid = fold_ids(g_fold, y.shape[0], self.folds).to(device)
        scores, cs = self._scores(x, y, fid, center_set, key=g_sample)
        return KFoldResult(lams=tuple(float(ell) for ell in self.lams), scores=scores,
                           fold_id=fid, center_set=cs)

    def _scores(self, x: Tensor, y: Tensor, fid: Tensor, center_set: CenterSet | None, *,
                key: int | torch.Generator | None = None) -> tuple[Tensor, CenterSet]:
        """(len(lams), folds) held-out MSE for the fold assignment ``fid`` on
        device data, and the center set the solves rode on (``center_set``,
        or the sampler's draw from ``key``)."""
        folds = torch.arange(self.folds, device=fid.device)
        held_out = fid[:, None] == folds[None, :]
        # column f trains on exactly the rows outside fold f: the mask panel
        # excludes them from the quadratic op AND the targets
        train_mask = (~held_out).to(torch.float32)
        held = held_out.to(torch.float32)
        y_panel = y[:, None] * train_mask
        est = FalkonRegressor(
            kernel=self.kernel, sigma=self.sigma,
            sampler=self.sampler if self.sampler is not None else BlessSampler(),
            warm_start=True)
        scores = []
        for i, lam in enumerate(self.lams):
            est.config = FitConfig(lam=lam, iters=self.iters, backend=self.backend,
                                   seed=self.seed, device=self.device)
            est.fit(x, y_panel, key=key, center_set=center_set if i == 0 else None,
                    row_mask=train_mask)
            pred = est.predict(x)  # (n, folds): one panel K_nM alpha
            sq = (pred - y[:, None]) ** 2
            scores.append(torch.sum(sq * held, dim=0) / torch.sum(held, dim=0))
        return torch.stack(scores), est.center_set_


__all__ = ["KFoldSweep", "KFoldResult", "fold_ids"]
