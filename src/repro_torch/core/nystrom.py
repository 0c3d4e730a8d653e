"""Direct Nystrom-KRR solver (paper Def. 4) and exact KRR — test oracles.

    alpha = (K_nM^T K_nM + lam n K_MM)^+ K_nM^T y        (Def. 4)
    c     = (K + lam n I)^{-1} y                          (Eq. 12, exact KRR)

The PyTorch counterpart of ``repro.core.nystrom``: dense O(n M^2) / O(n^3)
solves that FALKON's CG must converge to. The Gram blocks come through the
``Backend`` seam; the health fences are always armed (the jitter ladder
factors H or raises, and alpha passes a finite-output fence).
"""
from __future__ import annotations

import torch

from . import health
from .falkon import FalkonModel
from .gram import BackendLike, Kernel, resolve_backend

Tensor = torch.Tensor


def nystrom_krr(kernel: Kernel, x: Tensor, y: Tensor, centers: Tensor, lam: float,
                *, backend: BackendLike = None) -> FalkonModel:
    """Def. 4 direct solve; ``y`` may be (n,) or (n, k)."""
    n = x.shape[0]
    be = resolve_backend(backend, device=x.device)
    knm = be.gram_block(kernel, x, centers)
    kmm = be.gram_block(kernel, centers, centers)
    h = knm.T @ knm + lam * n * kmm
    chol, _ = health.safe_cholesky(h, what="Nystrom-KRR H = KnM^T KnM + lam n K_MM")
    rhs = knm.T @ y
    alpha = torch.cholesky_solve(rhs[:, None] if rhs.ndim == 1 else rhs, chol)
    alpha = alpha[:, 0] if y.ndim == 1 else alpha
    health.check_finite(alpha, "nystrom_krr alpha")
    return FalkonModel(centers=centers, alpha=alpha, kernel=kernel, backend=be,
                       lam=float(lam), n_train=n)


def exact_krr(kernel: Kernel, x: Tensor, y: Tensor, lam: float,
              *, backend: BackendLike = None) -> FalkonModel:
    """Eq. 12 exact solve; multi-output ``y`` (n, k) shares the Cholesky."""
    n = x.shape[0]
    be = resolve_backend(backend, device=x.device)
    k = be.gram_block(kernel, x, x)
    chol, _ = health.safe_cholesky(k + lam * n * torch.eye(n, dtype=k.dtype, device=k.device),
                                   what="exact-KRR K + lam n I")
    c = torch.cholesky_solve(y[:, None] if y.ndim == 1 else y, chol)
    c = c[:, 0] if y.ndim == 1 else c
    health.check_finite(c, "exact_krr alpha")
    return FalkonModel(centers=x, alpha=c, kernel=kernel, backend=be,
                       lam=float(lam), n_train=n)
