"""Sampling primitives for the BLESS ladder and the samplers.

The PyTorch counterpart of ``repro.core.sampling``. Two draw schemes cover
every sampler:

  * ``categorical`` — M i.i.d. with-replacement draws from an
    (unnormalized) weight vector by the inverse CDF: the ``_WEIGHT_FLOOR``
    normalisation, an integer ``torch.cumsum`` and ``torch.searchsorted``
    on uniforms.
    This is BLESS Alg. 1 line 9 (Multinomial(P_h, U_h)), which samples
    *with* replacement.
  * ``gumbel_topk`` — weighted sampling *without* replacement by the Gumbel
    trick: top-k of ``log w_i + G_i`` with i.i.d. standard Gumbel noise.

Both take raw (>= 0) weights; zero-weight slots are never drawn (``-inf``
logits for ``gumbel_topk``). Randomness comes from a CPU ``torch.Generator``
(``as_generator``): the draws are made on the CPU and moved to the weights'
device, so a seed gives the same uniforms on every device. They are not the
reference's threefry bits; tests compare distributions.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_WEIGHT_FLOOR = 1e-30  # floors the total weight (an all-zero buffer)
#: ``categorical`` sums its CDF in integer units of 2^-40 of the total
#: weight: a float ``cumsum`` on the card is a scan whose rounding order
#: changes from run to run (``torch.use_deterministic_algorithms`` lists
#: it), so a draw near a CDF step could change between two runs of one
#: seed; integer sums are exact in any order.
_CDF_UNITS = float(2 ** 40)


def as_generator(seed_or_generator: int | torch.Generator) -> torch.Generator:
    """Normalize a seed spelling to a CPU ``torch.Generator``.

    An int becomes a fresh generator seeded with it (so ``sample(0, ...)``
    always draws the same centers); a generator passes through and advances.
    """
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    if isinstance(seed_or_generator, int):
        return torch.Generator(device="cpu").manual_seed(seed_or_generator)
    raise TypeError(f"expected an int seed or a torch.Generator, got "
                    f"{type(seed_or_generator).__name__}")


def uniform(gen: torch.Generator, shape, device) -> Tensor:
    """U[0, 1) fp32 draws made on the CPU and moved to ``device``."""
    return torch.rand(shape, generator=gen).to(device)


def randint(gen: torch.Generator, high: int, shape, device) -> Tensor:
    """Uniform int64 draws in [0, high), made on the CPU, moved to ``device``."""
    return torch.randint(0, high, shape, generator=gen).to(device)


def categorical(key: int | torch.Generator, weights: Tensor, m: int) -> Tensor:
    """``m`` i.i.d. draws from ``p = weights / sum(weights)`` (inverse CDF).

    ``weights`` (R,) are unnormalized and may contain exact zeros (padded
    slots); zero-mass cells are never selected. The CDF is an integer
    ``cumsum`` of p in units of 2^-40 (``_CDF_UNITS``), so the draws are
    bit-repeatable on the card. Returns (m,) int64 indices into the weight
    buffer, on the weights' device.
    """
    w = torch.clamp(weights.double(), min=0.0)
    p = w / torch.clamp(torch.sum(w), min=_WEIGHT_FLOOR)
    cdf = torch.cumsum(torch.floor(p * _CDF_UNITS).to(torch.int64), dim=0)
    u = uniform(as_generator(key), (m,), weights.device).double()
    # the first cell whose CDF exceeds u * total: a zero-mass cell never does;
    # an all-zero weight vector has no valid cell, so stay inside the buffer
    pos = torch.searchsorted(cdf, torch.floor(u * cdf[-1]).to(torch.int64), right=True)
    return torch.clamp(pos, max=weights.shape[0] - 1)


def gumbel_topk(key: int | torch.Generator, weights: Tensor, k: int) -> Tensor:
    """Weighted sampling of ``k`` distinct indices without replacement.

    Perturbs ``log weights`` with i.i.d. Gumbel noise and takes the top-k;
    slots with weight <= 0 get ``-inf`` logits and are only drawn if fewer
    than ``k`` valid slots exist. Returns (k,) int64 indices, descending by
    perturbed logit.
    """
    w = weights.float()
    logw = torch.where(w > 0.0, torch.log(torch.clamp(w, min=_WEIGHT_FLOOR)),
                       torch.full_like(w, -torch.inf))
    u = torch.clamp(uniform(as_generator(key), w.shape, w.device),
                    min=torch.finfo(torch.float32).tiny)
    return torch.topk(logw - torch.log(-torch.log(u)), k).indices
