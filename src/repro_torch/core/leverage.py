"""Weighted Nystrom center sets and the exact ridge leverage scores (Eq. 1).

Part of the counterpart of ``repro.core.leverage``: the ``CenterSet``
convention (padded buffer + validity mask), ``uniform_center_set``, the
PSD helpers, and the O(n^3) oracles ``exact_rls`` / ``effective_dim``. The
approximate Eq. 3 scores come with the BLESS sampler.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gram import Kernel
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
