"""Kernel-family registry — one definition per family, shared by every path.

The PyTorch counterpart of ``repro.families``. A ``KernelFamily`` owns:

  * ``inv_scale`` — folds the bandwidth into the scalar the epilogue
    consumes (plain Python arithmetic: the CUDA wrappers pass it to the
    kernel as a float argument);
  * ``epilogue``  — the elementwise map from the pre-activation to kernel
    values, written once in torch. For distance families the pre-activation
    is the squared distance clamped at 0; for ``dot_only`` families it is
    the raw inner product ``x . z``;
  * ``cuda_id``   — the family's number in the CUDA epilogue switch
    (``kernels/csrc/gram_tile.cuh``). A family registered without one runs
    on ``TorchBackend`` only; ``CudaBackend`` refuses it by name.

This module is a leaf (it imports nothing from ``repro_torch``), so both
``repro_torch.core`` and ``repro_torch.kernels`` can import it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """One kernel family k(x, z) = epilogue(pre, inv_scale(sigma)).

    Attributes:
      name: registry key ("gaussian", "matern32", ...).
      inv_scale: sigma -> the scalar folded into the epilogue.
      epilogue: (pre, inv_scale) -> kernel values, elementwise torch ops.
      dot_only: the family is a function of x . z (no distance term).
      unit_diag: k(x, x) == 1 for every x.
      cuda_id: the id the CUDA epilogue switches on; None -> no CUDA epilogue.
    """

    name: str
    inv_scale: Callable[[float], float]
    epilogue: Callable[[Tensor, float], Tensor]
    dot_only: bool = False
    unit_diag: bool = True
    cuda_id: int | None = None


_FAMILY_REGISTRY: dict[str, KernelFamily] = {}


def register_kernel_family(family: KernelFamily, *, overwrite: bool = False) -> KernelFamily:
    """Register a family for resolution by name; returns it."""
    if not overwrite and family.name in _FAMILY_REGISTRY:
        raise ValueError(f"kernel family {family.name!r} is already registered; "
                         "pass overwrite=True to replace it")
    _FAMILY_REGISTRY[family.name] = family
    return family


def kernel_family_names() -> list[str]:
    """Sorted names of every registered kernel family."""
    return sorted(_FAMILY_REGISTRY)


def get_family(name: str) -> KernelFamily:
    """Resolve a family by name; the error lists the registry."""
    try:
        return _FAMILY_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel family {name!r}; registered: {kernel_family_names()}"
        ) from None


def diag_pre(family: KernelFamily, x: Tensor) -> Tensor:
    """Epilogue pre-activation for k(x_i, x_i): 0 for distance families,
    ``x . x`` for dot-product ones."""
    if family.dot_only:
        return torch.sum(x * x, dim=-1)
    return torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Built-in families. The +1e-30 under the sqrt is the same formula as the
# reference and as the CUDA epilogue: cross-path parity depends on it.
# ---------------------------------------------------------------------------


def _matern32(d2: Tensor, s: float) -> Tensor:
    r = torch.sqrt(d2 + 1e-30) * s
    return (1.0 + r) * torch.exp(-r)


GAUSSIAN = register_kernel_family(KernelFamily(
    name="gaussian",
    inv_scale=lambda sigma: 1.0 / (2.0 * sigma**2),
    epilogue=lambda d2, s: torch.exp(-d2 * s),
    cuda_id=0,
))

LAPLACIAN = register_kernel_family(KernelFamily(
    name="laplacian",
    inv_scale=lambda sigma: 1.0 / sigma,
    epilogue=lambda d2, s: torch.exp(-torch.sqrt(d2 + 1e-30) * s),
    cuda_id=1,
))

LINEAR = register_kernel_family(KernelFamily(
    name="linear",
    inv_scale=lambda sigma: 1.0,  # bandwidth-free
    epilogue=lambda prod, s: prod,
    dot_only=True,
    unit_diag=False,
    cuda_id=2,
))

#: Matern-3/2: (1 + r) e^{-r} with r = sqrt(3) ||x - z|| / sigma.
MATERN32 = register_kernel_family(KernelFamily(
    name="matern32",
    inv_scale=lambda sigma: 3.0**0.5 / sigma,
    epilogue=_matern32,
    cuda_id=3,
))

#: Cauchy (rational quadratic, alpha = 1): 1 / (1 + ||x - z||^2 / sigma^2).
CAUCHY = register_kernel_family(KernelFamily(
    name="cauchy",
    inv_scale=lambda sigma: 1.0 / sigma**2,
    epilogue=lambda d2, s: 1.0 / (1.0 + d2 * s),
    cuda_id=4,
))
