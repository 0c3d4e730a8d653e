"""Center samplers — the first slot of the paper's pipeline.

Part of the counterpart of ``repro.api.samplers``: the ``Sampler``
protocol, the seed convention (``as_generator``) and ``UniformSampler``.
Randomness comes from a ``torch.Generator``, which gives other draws than
JAX's threefry keys from the same seed; tests that need identical centers
pass a ``CenterSet`` across (``repro_torch.interop``).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from ..core.gram import BackendLike, Kernel
from ..core.leverage import CenterSet, uniform_center_set

Tensor = torch.Tensor


def as_generator(seed_or_generator: int | torch.Generator) -> torch.Generator:
    """Normalize a seed spelling to a CPU ``torch.Generator``.

    An int becomes a fresh generator seeded with it (so ``sample(0, ...)``
    always draws the same centers); a generator passes through and advances.
    Draws are made on the CPU and moved to the data's device, so the same
    seed gives the same centers on every device.
    """
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    if isinstance(seed_or_generator, int):
        return torch.Generator(device="cpu").manual_seed(seed_or_generator)
    raise TypeError(f"expected an int seed or a torch.Generator, got "
                    f"{type(seed_or_generator).__name__}")


def _bucket(x: int) -> int:
    """Quarter-pow2 buffer size: pow2 up to 32, then the smallest of
    {5/8, 3/4, 7/8, 1} * next-pow2 that fits (``repro.core.bless._bucket``),
    so center sets have the reference's padded shapes."""
    x = max(1, int(x))
    p = 1 << (x - 1).bit_length()
    if p <= 32:
        return p
    for c in (5 * p // 8, 3 * p // 4, 7 * p // 8):
        if c >= x:
            return c
    return p


@runtime_checkable
class Sampler(Protocol):
    """Anything that maps (seed, data, kernel) to a weighted center set."""

    def sample(self, key: int | torch.Generator, x: Tensor, kernel: Kernel, *,
               backend: BackendLike = None) -> CenterSet:
        """Return (J, A) as a padded ``CenterSet`` (idx/weight/mask/count)."""
        ...


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

    def sample(self, key: int | torch.Generator, x: Tensor, kernel: Kernel, *,
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


__all__ = ["Sampler", "as_generator", "UniformSampler"]
