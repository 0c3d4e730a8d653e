"""Kernel (Gram) computations and the kernel-operator backend registry.

The PyTorch counterpart of ``repro.core.gram``. ``Kernel`` is a frozen
dataclass over a family from ``repro_torch.families``; its ``cross`` /
``diag`` / ``gram`` are the plain-torch formulas. The same contractions are
served by the hand-written CUDA kernels through ``CudaBackend``
(``repro_torch.core.backend``). This module owns only the backend
*registry*, so the lower layers can resolve a backend by name without
importing the backend module at import time.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Union

import torch

from ..families import (  # noqa: F401 — re-exported public API
    KernelFamily,
    diag_pre,
    get_family,
    kernel_family_names,
    register_kernel_family,
)

if TYPE_CHECKING:  # pragma: no cover — type-only, avoids the import cycle
    from .backend import Backend

Tensor = torch.Tensor
BackendLike = Union["Backend", str, None]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A bounded positive-definite kernel ``k(x, z)``.

    Attributes:
      name: kernel family, resolved from the ``repro_torch.families`` registry.
      sigma: bandwidth (ignored by bandwidth-free families, e.g. "linear").
      kappa_sq: uniform bound on ``k(x, x)``.
    """

    name: str = "gaussian"
    sigma: float = 1.0
    kappa_sq: float = 1.0

    @property
    def family(self) -> KernelFamily:
        """The registered family (raises with the registry listed on typos)."""
        return get_family(self.name)

    def cross(self, x: Tensor, z: Tensor) -> Tensor:
        """Gram block ``k(x_i, z_j)`` of shape (n, m)."""
        fam = self.family
        return family_cross(fam, x, z, fam.inv_scale(self.sigma))

    #: The reference keeps a second entry that dodges an XLA:CPU fusion
    #: problem; torch has none, so it is the same function.
    cross_unfused = cross

    def diag(self, x: Tensor) -> Tensor:
        """``k(x_i, x_i)`` of shape (n,)."""
        fam = self.family
        if fam.unit_diag:
            return torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
        return fam.epilogue(diag_pre(fam, x), fam.inv_scale(self.sigma))

    def gram(self, x: Tensor) -> Tensor:
        return self.cross(x, x)


def sq_dists(x: Tensor, z: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances ``||x||^2 + ||z||^2 - 2 x.z``,
    clamped at 0 against fp cancellation (the kernels' form, not cdist)."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    zn = torch.sum(z * z, dim=-1)[None, :]
    return torch.clamp(xn + zn - 2.0 * (x @ z.T), min=0.0)


def family_cross(fam: KernelFamily, x: Tensor, z: Tensor, inv: float | Tensor) -> Tensor:
    """``fam``'s Gram block with the bandwidth already folded into ``inv``
    (``fam.inv_scale(sigma)``), a float or a 0-d tensor: the fused fit passes
    a tensor so that a captured graph reads a new bandwidth from its buffer."""
    if fam.dot_only:
        return fam.epilogue(x @ z.T, inv)
    return fam.epilogue(sq_dists(x, z), inv)


def make_kernel(name: str = "gaussian", sigma: float = 1.0, kappa_sq: float = 1.0) -> Kernel:
    """Build a ``Kernel`` after validating ``name`` against the registry."""
    get_family(name)  # fail fast with the registered families enumerated
    return Kernel(name=name, sigma=float(sigma), kappa_sq=float(kappa_sq))


def blocked_cross(kernel: Kernel, x: Tensor, z: Tensor, *, block: int = 4096) -> Tensor:
    """Gram ``k(X, Z)`` computed in row blocks of ``x`` to bound the peak of
    the intermediates (the distance block is (block, m))."""
    if x.shape[0] <= block:
        return kernel.cross(x, z)
    return torch.cat([kernel.cross(x[i:i + block], z) for i in range(0, x.shape[0], block)])


# ---------------------------------------------------------------------------
# Backend registry. ``repro_torch.core.backend`` registers its implementations
# here on import; callers resolve by name or pass an instance through.
# ---------------------------------------------------------------------------

_BACKEND_REGISTRY: dict[str, Callable[[], "Backend"]] = {}


def register_backend(name: str, factory: Callable[[], "Backend"]) -> None:
    """Register a zero-arg factory for ``resolve_backend(name)``."""
    _BACKEND_REGISTRY[name] = factory


def backend_names() -> list[str]:
    _ensure_backends_loaded()
    return sorted(_BACKEND_REGISTRY)


def resolve_backend(spec: BackendLike = None, *,
                    device: torch.device | str | None = None,
                    n: int | None = None) -> "Backend":
    """Resolve a backend spec: instance (passthrough), name, or None.

    ``None`` picks ``backend.default_backend(device, n=n)``: ``CudaBackend``
    for data on a CUDA device, wrapped in the out-of-core ``StreamBackend``
    past ``REPRO_STREAM_MIN_ROWS`` rows (``n``, when the caller knows it);
    data on the CPU raises unless the caller names the CPU path
    (``"torch"``).

    Composite specs ``"outer:inner"`` (``"stream:cuda"``, ``"stream:torch"``)
    resolve the outer name, then hand it the resolved inner through its
    ``with_inner`` hook, as ``repro.core.gram.resolve_backend`` does.
    """
    _ensure_backends_loaded()
    if spec is None:
        from .backend import default_backend

        return default_backend(device, n=n)
    if isinstance(spec, str):
        outer_name, _, inner_spec = spec.partition(":")
        try:
            outer = _BACKEND_REGISTRY[outer_name]()
        except KeyError:
            raise ValueError(
                f"unknown backend {outer_name!r}; registered: {sorted(_BACKEND_REGISTRY)}"
            ) from None
        if not inner_spec:
            return outer
        if not hasattr(outer, "with_inner"):
            raise ValueError(f"backend {outer_name!r} is not composable (no with_inner); "
                             f"cannot resolve {spec!r}")
        return outer.with_inner(resolve_backend(inner_spec, device=device, n=n))
    return spec


def _ensure_backends_loaded() -> None:
    from . import backend  # noqa: F401 — import side effect: registration
