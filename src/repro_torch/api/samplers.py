"""Composable leverage-score samplers — the first slot of the paper's pipeline.

The counterpart of ``repro.api.samplers``. Every sampler implements one
protocol,

    sample(key, x, kernel, *, backend=None) -> CenterSet

so BLESS (Alg. 1), BLESS-R (Alg. 2), the Sec. 2.3 baselines and the exact
oracle are interchangeable inside ``FalkonRegressor`` / ``NystromRegressor``.
All heavy work goes through the kernel-operator ``Backend`` seam: on the
card the Eq. 3 scores are K5 (up to 1024 centers) or K1 + K6.

Randomness comes from a ``torch.Generator`` (``as_generator``), which gives
other draws than JAX's threefry keys from the same seed; tests that need
identical centers pass a ``CenterSet`` across (``repro_torch.interop``).
Samplers are frozen dataclasses: hashable, comparable by configuration, and
safe to share across estimators.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from ..core.baselines import _padded_set, recursive_rls, squeak, two_pass
from ..core.bless import BlessResult, _bucket, bless, bless_r
from ..core.chen_yang import fast_spectral_rls
from ..core.gram import BackendLike, Kernel
from ..core.leverage import CenterSet, exact_rls, uniform_center_set
from ..core.sampling import as_generator, categorical, gumbel_topk

Tensor = torch.Tensor
Key = int | torch.Generator


@runtime_checkable
class Sampler(Protocol):
    """Anything that maps (seed, data, kernel) to a weighted center set."""

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Return (J, A) as a padded ``CenterSet`` (idx/weight/mask/count)."""
        ...


@dataclasses.dataclass(frozen=True)
class BlessSampler:
    """BLESS (paper Alg. 1): bottom-up ladder, sampling with replacement.

    Parameters mirror ``repro_torch.core.bless.bless``; ``lam`` is the
    sampler's own regularization scale — keep it well above the solver's
    lam (the paper's lam_bless >> lam_falkon trick, Sec. 4).
    """

    lam: float = 1e-3
    q: float = 2.0
    q1: float = 3.0
    q2: float = 3.0
    lam0: float | None = None
    t: float = 1.0
    m_cap: int | None = None

    def ladder(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> BlessResult:
        """The full regularization path (every BlessLevel), for introspection."""
        return bless(key, x, kernel, self.lam, q=self.q, q1=self.q1, q2=self.q2,
                     lam0=self.lam0, t=self.t, m_cap=self.m_cap, backend=backend)

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Run Alg. 1 and return the final level's weighted (J, A)."""
        return self.ladder(key, x, kernel, backend=backend).final.centers


@dataclasses.dataclass(frozen=True)
class BlessRSampler:
    """BLESS-R (paper Alg. 2): rejection sampling, without replacement."""

    lam: float = 1e-3
    q: float = 2.0
    q2: float = 3.0
    lam0: float | None = None
    t: float = 1.0
    m_cap: int | None = None

    def ladder(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> BlessResult:
        """The full regularization path (every BlessLevel), for introspection."""
        return bless_r(key, x, kernel, self.lam, q=self.q, q2=self.q2, lam0=self.lam0,
                       t=self.t, m_cap=self.m_cap, backend=backend)

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Run Alg. 2 and return the final level's weighted (J, A)."""
        return self.ladder(key, x, kernel, backend=backend).final.centers


@dataclasses.dataclass(frozen=True)
class UniformSampler:
    """Uniform column sampling — the fastest, highest-variance baseline.

    ``weights="nystrom"`` sets A = (M/n) I; ``weights="identity"`` sets A = I
    (the classic FALKON-uniform preconditioner). ``replace`` switches between
    i.i.d. draws and a without-replacement choice.
    """

    m: int
    weights: str = "nystrom"  # "nystrom" (A = M/n I) | "identity" (A = I)
    replace: bool = True

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Draw m uniform centers from x's rows (weights per ``weights``)."""
        if self.weights not in ("nystrom", "identity"):
            raise ValueError(f"weights must be 'nystrom' or 'identity', got {self.weights!r}")
        gen = as_generator(key)
        n = x.shape[0]
        if not self.replace and self.m > n:
            raise ValueError(f"cannot draw {self.m} distinct centers from {n} rows")
        if self.replace:
            idx = torch.randint(0, n, (self.m,), generator=gen)
        else:
            idx = torch.randperm(n, generator=gen)[: self.m]
        cs = uniform_center_set(idx, n, _bucket(self.m))  # owns the padding rules
        if self.weights == "identity":
            cs = cs._replace(weight=torch.ones_like(cs.weight))
        return cs


@dataclasses.dataclass(frozen=True)
class ExactRlsSampler:
    """The O(n^3) oracle: M i.i.d. draws from the *exact* ridge leverage
    score distribution (Eq. 1). Weights follow the Alg. 1 line-10
    convention with the candidate set = [n]: A = M diag(p_{j_1}, ...)."""

    m: int
    lam: float = 1e-3

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """m i.i.d. draws from the exact Eq. 1 leverage distribution."""
        scores = exact_rls(kernel, x, self.lam)
        p = scores / torch.sum(scores)
        mbuf = _bucket(self.m)
        pos = categorical(as_generator(key), p, mbuf)
        mask = torch.arange(mbuf, device=x.device) < self.m
        return CenterSet(idx=pos, weight=torch.where(mask, self.m * p[pos], 1.0).float(),
                         mask=mask, count=torch.tensor(self.m, dtype=torch.int64))


# ---------------------------------------------------------------------------
# Related-work samplers (Sec. 2.3 baselines) over repro_torch.core.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecursiveRlsSampler:
    """RECURSIVE-RLS [9] (Musco & Musco) as a drop-in Sampler."""

    lam: float = 1e-3
    q2: float = 2.0
    depth: int | None = None
    m_cap: int | None = None

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Run RECURSIVE-RLS over the halving tree; returns its (J, A)."""
        return recursive_rls(key, x, kernel, self.lam, q2=self.q2, depth=self.depth,
                             m_cap=self.m_cap, backend=backend)


@dataclasses.dataclass(frozen=True)
class SqueakSampler:
    """SQUEAK [8] (Calandriello, Lazaric & Valko) as a drop-in Sampler."""

    lam: float = 1e-3
    qbar: float = 2.0
    n_chunks: int | None = None
    m_cap: int | None = None

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Run SQUEAK's streaming merge; returns its weighted (J, A)."""
        return squeak(key, x, kernel, self.lam, qbar=self.qbar, n_chunks=self.n_chunks,
                      m_cap=self.m_cap, backend=backend)


@dataclasses.dataclass(frozen=True)
class TwoPassSampler:
    """Two-pass sampling [6] (El Alaoui & Mahoney) as a drop-in Sampler."""

    lam: float = 1e-3
    m2: int = 256
    m1: int | None = None

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Pass 1: uniform pilot scores; pass 2: the m2 weighted draws."""
        return two_pass(key, x, kernel, self.lam, m1=self.m1, m2=self.m2, backend=backend)


@dataclasses.dataclass(frozen=True)
class ChenYangSampler:
    """Chen & Yang (2021) fast statistical leverage approximation.

    One-shot spectral RLS estimate (``repro_torch.core.chen_yang``), then
    the ``m`` centers are drawn *without* replacement by Gumbel-top-k
    proportionally to the estimated scores, with inclusion-rate weights
    A_jj = min(m l^_j / sum l^, 1).
    """

    m: int
    lam: float = 1e-3
    m0: int | None = None  # landmark count; None -> default_sketch_size(n)

    def scores(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> Tensor:
        """The (n,) spectral RLS estimates themselves, for introspection."""
        return fast_spectral_rls(key, kernel, x, self.lam, m0=self.m0, backend=backend)

    def sample(self, key: Key, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Sketch, score, and draw m distinct centers ~ l^ (Gumbel-top-k)."""
        gen = as_generator(key)
        s = fast_spectral_rls(gen, kernel, x, self.lam, m0=self.m0, backend=backend)
        sel = gumbel_topk(gen, s, self.m)
        pi = torch.clamp(self.m * s[sel] / torch.sum(s), max=1.0)
        return _padded_set(sel, pi, _bucket(self.m))


__all__ = [
    "Sampler", "as_generator", "BlessSampler", "BlessRSampler", "UniformSampler",
    "ExactRlsSampler", "RecursiveRlsSampler", "SqueakSampler", "TwoPassSampler",
    "ChenYangSampler",
]
