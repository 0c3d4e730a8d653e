"""Ridge leverage scores: exact (Eq. 1) and Nystrom-approximate (Eq. 3).

The counterpart of ``repro.core.leverage``: the ``CenterSet`` convention
(padded buffer + validity mask), ``uniform_center_set``, the PSD helpers,
the O(n^3) oracles ``exact_rls`` / ``effective_dim``, and the approximate
scores ``approx_rls`` / ``approx_rls_all``. The Eq. 3 inner contraction
goes through the ``Backend.rls_scores`` seam (``repro_torch.core.backend``);
the scorer is the reference's host path (``_approx_rls_host``), since
PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gram import BackendLike, Kernel, resolve_backend
from .health import chol_with_jitter_ladder

Tensor = torch.Tensor

_SCORE_FLOOR = 1e-12  # keep sampling probabilities strictly positive


class CenterSet(NamedTuple):
    """A weighted Nystrom center set (J, A) on a padded buffer.

    idx:    (Mbuf,) int64 indices into [n]; arbitrary on invalid slots.
    weight: (Mbuf,) float32 diag(A); 1 on invalid slots.
    mask:   (Mbuf,) bool validity.
    count:  ()      int64 number of valid centers (|J|).
    """

    idx: Tensor
    weight: Tensor
    mask: Tensor
    count: Tensor

    @staticmethod
    def empty(mbuf: int) -> "CenterSet":
        return CenterSet(
            idx=torch.zeros((mbuf,), dtype=torch.int64),
            weight=torch.ones((mbuf,), dtype=torch.float32),
            mask=torch.zeros((mbuf,), dtype=torch.bool),
            count=torch.tensor(0, dtype=torch.int64),
        )


def approx_rls(kernel: Kernel, x_cand: Tensor, cand_mask: Tensor, x_all: Tensor,
               centers: CenterSet, lam: float, *, backend: BackendLike = None) -> Tensor:
    """Approximate leverage scores (Eq. 3) of candidates against (J, A).

      l~_J(i, lam) = (lam n)^{-1} (K_ii - K_Ji^T (K_JJ + lam n A)^{-1} K_Ji)

    n is the *full* dataset size (x_all.shape[0]); candidates/centers live
    on padded buffers with masks. Invalid centers are neutralized by zeroing
    their Gram rows/cols and pinning the regularized diagonal to 1.
    Returns (Rbuf,) scores clipped to [_SCORE_FLOOR, 1]; entries at invalid
    candidates are _SCORE_FLOOR.
    """
    backend = resolve_backend(backend, device=x_all.device)
    n = x_all.shape[0]
    lamn = float(lam) * n
    if int(centers.count) > 0:
        idx = centers.idx.to(x_all.device)
        mask = centers.mask.to(x_all.device)
        reg = torch.where(mask, lamn * centers.weight.to(x_all.device),
                          torch.ones_like(centers.weight, device=x_all.device))
        scores = backend.rls_scores(kernel, x_cand, x_all[idx], mask, reg, lamn)
    else:
        scores = kernel.diag(x_cand) / lamn
    scores = torch.clamp(scores, _SCORE_FLOOR, 1.0)
    return torch.where(cand_mask.to(scores.device), scores,
                       torch.full_like(scores, _SCORE_FLOOR))


def approx_rls_all(kernel: Kernel, x_all: Tensor, centers: CenterSet, lam: float, *,
                   block: int = 4096, backend: BackendLike = None) -> Tensor:
    """Eq. 3 scores for every i in [n], blocked over rows (used by Fig. 1)."""
    backend = resolve_backend(backend, device=x_all.device)
    parts = [approx_rls(kernel, x_all[i:i + block],
                        torch.ones((min(block, x_all.shape[0] - i),), dtype=torch.bool,
                                   device=x_all.device),
                        x_all, centers, lam, backend=backend)
             for i in range(0, x_all.shape[0], block)]
    return torch.cat(parts) if parts else x_all.new_zeros((0,))


def uniform_center_set(idx: Tensor, n: int, mbuf: int) -> CenterSet:
    """Uniformly sampled centers J with the A = (|J|/n) I convention, padded
    to ``mbuf`` slots (invalid slots: index 0, weight 1, mask False)."""
    m = idx.shape[0]
    if m > mbuf:
        raise ValueError(f"{m} centers do not fit a buffer of {mbuf}")
    pad = mbuf - m
    dev = idx.device
    return CenterSet(
        idx=torch.cat([idx.to(torch.int64), torch.zeros(pad, dtype=torch.int64, device=dev)]),
        weight=torch.cat([torch.full((m,), m / n, dtype=torch.float32, device=dev),
                          torch.ones(pad, dtype=torch.float32, device=dev)]),
        mask=torch.arange(mbuf, device=dev) < m,
        count=torch.tensor(m, dtype=torch.int64),
    )


def exact_rls(kernel: Kernel, x: Tensor, lam: float) -> Tensor:
    """Exact ridge leverage scores  l(i, lam) = [K (K + lam n I)^{-1}]_ii.

    O(n^3) — the oracle the approximations are measured against (Eq. 1).
    """
    n = x.shape[0]
    k = kernel.gram(x)
    s = _psd_solve(k + lam * n * torch.eye(n, dtype=k.dtype, device=k.device), k)
    return torch.clamp(torch.diagonal(s), _SCORE_FLOOR, 1.0)


def effective_dim(kernel: Kernel, x: Tensor, lam: float) -> Tensor:
    """d_eff(lam) = sum_i l(i, lam)."""
    return torch.sum(exact_rls(kernel, x, lam))


def _chol_with_jitter(a: Tensor) -> Tensor:
    """Cholesky through the health ladder (``health.chol_with_jitter_ladder``)."""
    chol, _ = chol_with_jitter_ladder(a)
    return chol


def _psd_solve(a: Tensor, b: Tensor) -> Tensor:
    return torch.cholesky_solve(b, _chol_with_jitter(a))
