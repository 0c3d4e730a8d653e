"""Fast statistical leverage approximation (Chen & Yang, 2021).

The PyTorch counterpart of ``repro.core.chen_yang``: a one-shot spectral
estimate of the ridge leverage scores. Uniformly subsample m0 landmark
columns S, eigendecompose the (m0, m0) landmark Gram, and read every point's
score off the Nystrom factor

    C = K_nS V diag(mu)^{-1/2},        K_SS = V diag(mu) V^T,
    C^T C = U diag(s) U^T,
    l^_i  = sum_j (C U)_ij^2 / (s_j + lam n),

which is exactly [K^ (K^ + lam n I)^{-1}]_ii for the Nystrom K^ = C C^T.
O(n m0^2 + m0^3) with two small eigh's. Both Gram blocks go through the
``Backend`` seam (K1 on the card).
"""
from __future__ import annotations

import math

import torch

from .gram import BackendLike, Kernel, resolve_backend
from .leverage import _SCORE_FLOOR
from .sampling import as_generator

Tensor = torch.Tensor


def default_sketch_size(n: int) -> int:
    """Landmark count heuristic: ~4 sqrt(n), floored at 64, capped at n."""
    return min(n, max(64, 4 * int(math.ceil(math.sqrt(n)))))


def fast_spectral_rls(key: int | torch.Generator, kernel: Kernel, x: Tensor, lam: float, *,
                      m0: int | None = None, backend: BackendLike = None) -> Tensor:
    """Chen & Yang's one-shot spectral RLS estimate for every point.

    Args:
      key: seed or CPU ``torch.Generator`` (drives the landmark subsample).
      kernel: bounded PSD kernel.
      x: (n, d) dataset.
      lam: regularization (the paper's lambda).
      m0: landmark count; default ``default_sketch_size(n)``.
      backend: kernel-operator backend (instance, registry name, or None
        for the data's device).

    Returns:
      (n,) fp32 scores in [_SCORE_FLOOR, 1].
    """
    n = x.shape[0]
    backend = resolve_backend(backend, device=x.device)
    m0 = default_sketch_size(n) if m0 is None else min(n, int(m0))
    sel = torch.randperm(n, generator=as_generator(key))[:m0].to(x.device)
    xs = x[sel]
    kss = backend.gram_block(kernel, xs, xs).float()
    mu, v = torch.linalg.eigh(kss)
    # floor the landmark spectrum: near-null directions of K_SS carry no
    # signal and would otherwise blow up the whitening mu^{-1/2}
    mu = torch.clamp(mu, min=1e-6 * max(float(mu.max()), 1.0))
    c = backend.gram_block(kernel, x, xs).float() @ (v / torch.sqrt(mu)[None, :])
    s, u = torch.linalg.eigh(c.T @ c)
    cu = c @ u
    scores = torch.sum(cu * cu / (torch.clamp(s, min=0.0) + lam * n)[None, :], dim=1)
    return torch.clamp(scores, _SCORE_FLOOR, 1.0)
