"""Kernel-operator backends — the single seam for every hot contraction.

The PyTorch counterpart of ``repro.core.backend``. The contractions:

  * ``gram_block``      — a K(X, Z) block (K_MM, the oracles)
  * ``masked_quadform`` — Eq. 3's inner term K_Ji^T (K_JJ + lam n A)^{-1} K_Ji
  * ``rls_scores``      — the Eq. 3 scores built on it
  * ``knm_quadratic`` / ``knm_t`` — the CG matvec K_nM^T K_nM v and its
    right-hand side K_nM^T y, never materializing K_nM
  * ``knm_matvec``      — K(X, Z) v, the predict / Nystrom-KRR forward pass

Two backends serve them:

  * ``TorchBackend`` — the pure-torch row streamer, counterpart of
    ``JnpBackend``. Complete (every method, ``mask=`` included) and runs on
    whatever device its tensors are on. It is the port's own oracle and
    what ``FitConfig(device="cpu")`` runs; the one graph-safe backend.
  * ``CudaBackend``  — the hand-written CUDA kernels, counterpart of
    ``PallasBackend``: ``gram_block`` is K1, ``knm_quadratic`` K2 (with a
    ``mask=`` panel the row-masked K7), ``knm_t`` K3 (a mask folds into the
    targets first), ``knm_matvec`` K4, ``rls_scores`` the fused Eq. 3 score
    K5 (up to ``MAX_FUSED_M`` centers) and ``masked_quadform`` K1 + the
    quadratic form K6.

Two wrap another backend:

  * ``ShardedBackend`` — data-parallel over a ``torch.distributed`` group
    (``repro_torch.core.distributed``): each rank's rows through its inner
    backend, partials summed in rank order.
  * ``GuardedBackend`` — a primary with a per-dispatch fallback for data
    on the CPU (on the card a failure is recorded and re-raised), opt-in
    only: no default picks it.

Backends are frozen dataclasses: hashable and comparable by configuration.
Selection is by instance, by registry name ("torch" | "cuda" | "sharded" |
"guarded" | "stream", or a composite "stream:<inner>"), or None for
``default_backend(device)``, which picks ``CudaBackend`` for data on a CUDA
device (``ShardedBackend`` in a multi-rank group past ``SHARD_MIN_ROWS``
rows, the out-of-core ``StreamBackend`` around the pick past
``REPRO_STREAM_MIN_ROWS``) and raises for data elsewhere: the CPU path is
taken only when the caller names it.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, ClassVar

import torch

from ..kernels.falkon_matvec import ops as falkon_ops
from ..kernels.gram import ops as gram_ops
from ..kernels.quadform import ops as quadform_ops
from ..kernels.rls_score import ops as rls_ops
from . import health
from .gram import Kernel, blocked_cross, register_backend
from .leverage import _chol_with_jitter

Tensor = torch.Tensor
KnmQuadraticOp = Callable[[Tensor], Tensor]

#: rows per streamed block of ``TorchBackend`` (a (block, M) Gram slab).
STREAM_BLOCK = 8192
#: largest (chunk, Mbuf) fp32 Gram slab ``CudaBackend.masked_quadform``
#: builds per K6 call (the whole (R, M) block at the predictive-variance
#: shape, 10^5 x 10^4, would be 4 GB).
QUADFORM_SLAB_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Backend:
    """Abstract kernel-operator backend (see module docstring)."""

    name: ClassVar[str] = "abstract"
    #: True if every method is plain torch that a CUDA graph can capture
    #: (no host sync, no host-side branch on a tensor's value): the
    #: counterpart of the reference's ``jit_safe``. ``falkon_fit`` takes
    #: its fused, graph-captured solve only on such a backend.
    graph_safe: ClassVar[bool] = False

    def gram_block(self, kernel: Kernel, x: Tensor, z: Tensor) -> Tensor:
        """K(X, Z) of shape (n, m)."""
        raise NotImplementedError

    def masked_quadform(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                        mask: Tensor, reg: Tensor) -> Tensor:
        """q_i = K_Ji^T (K_JJ * mask + diag(reg))^{-1} K_Ji for each candidate.

        ``z`` (Mbuf, d) are padded center coordinates, ``mask`` (Mbuf,) their
        validity, ``reg`` (Mbuf,) the regularized diagonal (lam n A on valid
        slots, 1 on padding). Returns (Rbuf,) fp32.
        """
        raise NotImplementedError

    def rls_scores(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                   z_mask: Tensor, reg: Tensor, lamn: Tensor | float) -> Tensor:
        """Eq. 3 scores (K_ii - K_Ji^T (K_JJ + lam n A)^{-1} K_Ji) / (lam n)
        for each candidate row; arguments as in ``masked_quadform``, ``lamn``
        the scalar lam * n. Unclipped. The default composes
        ``masked_quadform`` with the family diagonal."""
        kdiag = kernel.diag(x_cand)
        quad = self.masked_quadform(kernel, x_cand, z, z_mask, reg)
        return (kdiag - quad) / lamn

    def knm_quadratic(self, kernel: Kernel, x: Tensor, z: Tensor, *,
                      mask: Tensor | None = None) -> KnmQuadraticOp:
        """The v -> K_nM^T (K_nM v) operator for CG.

        The op takes an fp32 vector (M,) or an (M, k) panel: each Gram block
        serves every column. ``mask`` — optional per-column row-exclusion
        weights, (n,) or (n, k): column j computes ``K_nM^T diag(mask[:, j])
        K_nM v_j``. ``mask=None`` is the unmasked program.
        """
        raise NotImplementedError

    def knm_t(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
              mask: Tensor | None = None) -> Tensor:
        """K_nM^T y — the CG right-hand side(s); ``y`` (n,) -> (M,) or (n, k)
        -> (M, k). ``mask`` (shaped like ``y``) computes K_nM^T (mask * y)."""
        raise NotImplementedError

    def knm_operators(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
                      mask: Tensor | None = None) -> tuple[KnmQuadraticOp, Tensor]:
        """(quadratic op, K_nM^T y) together, ``mask`` applied to both."""
        return (self.knm_quadratic(kernel, x, z, mask=mask),
                self.knm_t(kernel, x, z, y, mask=mask))

    def knm_matvec(self, kernel: Kernel, x: Tensor, z: Tensor, v: Tensor) -> Tensor:
        """K(X, Z) v — ``v`` (M,) -> (n,), or an (M, k) panel -> (n, k)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Pure-torch reference backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TorchBackend(Backend):
    """Pure-torch row-streaming backend (the port's numerical reference)."""

    name: ClassVar[str] = "torch"
    graph_safe: ClassVar[bool] = True
    block: int = STREAM_BLOCK  # rows per streamed Gram block

    def gram_block(self, kernel: Kernel, x: Tensor, z: Tensor) -> Tensor:
        """K(X, Z) (n, m), streamed in row blocks."""
        return blocked_cross(kernel, x, z, block=self.block)

    def masked_quadform(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                        mask: Tensor, reg: Tensor) -> Tensor:
        """Eq. 3 quadratic form on the padded K_JJ via one Cholesky factor."""
        m = mask.to(z.dtype)
        kjj = kernel.cross(z, z) * (m[:, None] * m[None, :]) + torch.diag(reg.to(z.dtype))
        g = kernel.cross(x_cand, z) * m[None, :]
        chol = _chol_with_jitter(kjj)
        v = torch.linalg.solve_triangular(chol, g.T, upper=False)
        return torch.sum(v * v, dim=0)

    def knm_quadratic(self, kernel: Kernel, x: Tensor, z: Tensor, *,
                      mask: Tensor | None = None) -> KnmQuadraticOp:
        """CG quadratic op over the row streamer; optional row ``mask``."""
        from .falkon import local_knm_quadratic

        return local_knm_quadratic(kernel, x, z, block=self.block, mask=mask)

    def knm_t(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
              mask: Tensor | None = None) -> Tensor:
        """K_nM^T y, streamed; ``mask`` folds into the targets."""
        from .falkon import local_knm_t

        return local_knm_t(kernel, x, z, y, block=self.block, mask=mask)

    def knm_matvec(self, kernel: Kernel, x: Tensor, z: Tensor, v: Tensor) -> Tensor:
        """K(X, Z) v, streamed over row blocks."""
        parts = [kernel.cross(x[i:i + self.block], z) @ v
                 for i in range(0, x.shape[0], self.block)]
        if not parts:
            return v.new_zeros((0,) + tuple(v.shape[1:]))
        return torch.cat(parts)


# ---------------------------------------------------------------------------
# Hand-written CUDA kernel backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written CUDA kernels (K1-K7); counterpart of ``PallasBackend``.

    ``bf16=True`` rounds the operands of every Gram tile's x . z term, and
    of the G W product of K5 and K6, to bf16 (fp32 accumulation; norms,
    epilogues and the other contractions stay fp32); expect ~1e-2 relative
    error on kernel values for unit-scale data.

    Tensors on the CPU go to each kernel's plain version (that is how the
    wrappers are built); the entry points never put data there unless the
    caller asked for the CPU.
    """

    name: ClassVar[str] = "cuda"
    bf16: bool = False

    @staticmethod
    def _params(kernel: Kernel) -> tuple[str, float]:
        gram_ops.cuda_family_id(kernel.name)  # refuses a family without a CUDA epilogue
        return kernel.name, float(kernel.sigma)

    def gram_block(self, kernel: Kernel, x: Tensor, z: Tensor) -> Tensor:
        """K(X, Z) (n, m) fp32 from K1."""
        kind, sigma = self._params(kernel)
        return gram_ops.gram(x, z, sigma, kind=kind, bf16=self.bf16)

    def _inverse(self, kernel: Kernel, z: Tensor, mask: Tensor,
                 reg: Tensor) -> tuple[Tensor, Tensor]:
        """(mask as fp32, W = (K_JJ * mask + diag(reg))^{-1}): K1 builds K_JJ,
        the health ladder factors it, and ``cholesky_solve`` forms the
        explicit W the kernels contract against (M ~ d_eff, so it is cheap;
        the reference forms it the same way, outside its kernels)."""
        m = mask.to(torch.float32)
        kjj = self.gram_block(kernel, z, z) * (m[:, None] * m[None, :]) + torch.diag(
            reg.to(torch.float32))
        eye = torch.eye(kjj.shape[0], dtype=kjj.dtype, device=kjj.device)
        return m, torch.cholesky_solve(eye, _chol_with_jitter(kjj))

    def masked_quadform(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                        mask: Tensor, reg: Tensor) -> Tensor:
        """Eq. 3 quadratic form: K1 Gram slabs of at most
        ``QUADFORM_SLAB_BYTES``, masked, each contracted by K6 against the
        explicit (Mbuf, Mbuf) inverse."""
        m, w = self._inverse(kernel, z, mask, reg)
        rows = max(1, QUADFORM_SLAB_BYTES // (4 * max(1, z.shape[0])))
        parts = [quadform_ops.quadform(self.gram_block(kernel, x_cand[i:i + rows], z)
                                       * m[None, :], w, bf16=self.bf16)
                 for i in range(0, x_cand.shape[0], rows)]
        return torch.cat(parts) if parts else x_cand.new_zeros((0,))

    def rls_scores(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                   z_mask: Tensor, reg: Tensor, lamn: Tensor | float) -> Tensor:
        """Eq. 3 scores through the fused K5 (Gram row -> quadratic form ->
        score in one launch) up to ``MAX_FUSED_M`` centers; above it the
        composition of ``masked_quadform`` (K1 + K6) with the diagonal."""
        if z.shape[0] > rls_ops.MAX_FUSED_M:
            return super().rls_scores(kernel, x_cand, z, z_mask, reg, lamn)
        kind, sigma = self._params(kernel)
        m, w = self._inverse(kernel, z, z_mask, reg)
        return rls_ops.rls_score(x_cand, z, w, m, lamn, sigma, kind=kind, bf16=self.bf16)

    def knm_quadratic(self, kernel: Kernel, x: Tensor, z: Tensor, *,
                      mask: Tensor | None = None) -> KnmQuadraticOp:
        """CG quadratic op through K2; (M,) or (M, k) iterates. A ``mask``
        ((n,) or (n, k)) runs the row-masked K7 instead."""
        kind, sigma = self._params(kernel)

        def op(v: Tensor) -> Tensor:
            return falkon_ops.falkon_matvec(x, z, v, sigma, kind=kind, bf16=self.bf16, mask=mask)

        return op

    def knm_t(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
              mask: Tensor | None = None) -> Tensor:
        """K_nM^T y through K3; (n,) -> (M,) or (n, k) -> (M, k). A ``mask``
        shaped like ``y`` folds into the targets, K_nM^T (mask * y): it
        enters linearly, so K3 needs no masked variant."""
        if mask is not None:
            y = y * mask.to(y.dtype)
        kind, sigma = self._params(kernel)
        return falkon_ops.knm_t(x, z, y, sigma, kind=kind, bf16=self.bf16)

    def knm_matvec(self, kernel: Kernel, x: Tensor, z: Tensor, v: Tensor) -> Tensor:
        """K(X, Z) v through K4; (M,) -> (n,) or (M, k) -> (n, k)."""
        kind, sigma = self._params(kernel)
        return falkon_ops.knm_matvec(x, z, v, sigma, kind=kind, bf16=self.bf16)


# ---------------------------------------------------------------------------
# Data-parallel backend over a torch.distributed group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedBackend(Backend):
    """Data-parallel over a ``torch.distributed`` group; counterpart of the
    reference's shard_map ``ShardedBackend``.

    Every rank is called with the whole X; each keeps its rows
    (``distributed.shard_rows``) and contracts them with ``inner`` (None:
    ``backend_for_device`` of the data, so the CUDA kernels on the card);
    (M, .) partials are summed in rank order, row-parallel outputs gathered.
    Every method first checks that the ranks hold the same data
    (``distributed.check_replicated``: ``ValueError`` if they do not).
    ``group`` None is the default group, or a world of one without one.
    ``rls_scores`` is the base composition over the sharded
    ``masked_quadform``, as in the reference. ``collectives`` counts the
    collectives issued, over every instance.
    """

    name: ClassVar[str] = "sharded"
    collectives: ClassVar[int] = 0
    group: torch.distributed.ProcessGroup | None = None
    inner: Backend | None = None

    def _group(self):
        from .distributed import data_group

        return self.group if self.group is not None else data_group()

    def _inner(self, x: Tensor) -> Backend:
        return self.inner if self.inner is not None else backend_for_device(x.device)

    def gram_block(self, kernel: Kernel, x: Tensor, z: Tensor) -> Tensor:
        """K(X, Z) with X's rows sharded, Z replicated; gathered to (n, m)."""
        from .distributed import check_replicated, gather_rows, shard_rows

        g = self._group()
        check_replicated(g, x, z)
        return gather_rows(g, self._inner(x).gram_block(kernel, shard_rows(g, x), z),
                           x.shape[0])

    def masked_quadform(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                        mask: Tensor, reg: Tensor) -> Tensor:
        """Eq. 3 quadratic form: candidates sharded, the (Mbuf, Mbuf) factor
        replicated (each rank's inner backend factors it; <= d_eff^2)."""
        from .distributed import check_replicated, gather_rows, shard_rows

        g = self._group()
        check_replicated(g, x_cand, z, mask, reg)
        local = self._inner(x_cand).masked_quadform(kernel, shard_rows(g, x_cand), z, mask, reg)
        return gather_rows(g, local, x_cand.shape[0])

    def knm_quadratic(self, kernel: Kernel, x: Tensor, z: Tensor, *,
                      mask: Tensor | None = None) -> KnmQuadraticOp:
        """CG quadratic op with X (and a ``mask`` panel) row-sharded and the
        (M,) / (M, k) partials summed in rank order."""
        from .distributed import check_replicated, dist_knm_quadratic, shard_rows

        g = self._group()
        check_replicated(g, x, z, mask)
        ms = None if mask is None else shard_rows(g, mask)
        return dist_knm_quadratic(g, kernel, shard_rows(g, x), z, x.shape[0], mask=ms,
                                  inner=self._inner(x))

    def knm_t(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
              mask: Tensor | None = None) -> Tensor:
        """K_nM^T y with X, y row-sharded; ``mask`` folds into the targets."""
        from .distributed import check_replicated, dist_knm_t, shard_rows

        g = self._group()
        check_replicated(g, x, z, y, mask)
        if mask is not None:
            y = y * mask.to(y.dtype)
        return dist_knm_t(g, kernel, shard_rows(g, x), shard_rows(g, y), z, x.shape[0],
                          inner=self._inner(x))

    def knm_operators(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
                      mask: Tensor | None = None) -> tuple[KnmQuadraticOp, Tensor]:
        """(quadratic op, K_nM^T y), X sliced to this rank's rows once."""
        from .distributed import check_replicated, dist_knm_quadratic, dist_knm_t, shard_rows

        g = self._group()
        check_replicated(g, x, z, y, mask)
        xs, inner, n = shard_rows(g, x), self._inner(x), x.shape[0]
        ym = y if mask is None else y * mask.to(y.dtype)
        ms = None if mask is None else shard_rows(g, mask)
        return (dist_knm_quadratic(g, kernel, xs, z, n, mask=ms, inner=inner),
                dist_knm_t(g, kernel, xs, shard_rows(g, ym), z, n, inner=inner))

    def knm_matvec(self, kernel: Kernel, x: Tensor, z: Tensor, v: Tensor) -> Tensor:
        """K(X, Z) v, row-parallel, gathered; (M,) or (M, k) ``v``."""
        from .distributed import check_replicated, dist_knm_matvec, shard_rows

        g = self._group()
        check_replicated(g, x, z, v)
        return dist_knm_matvec(g, kernel, shard_rows(g, x), z, v, x.shape[0],
                               inner=self._inner(x))


# ---------------------------------------------------------------------------
# Opt-in guarded backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GuardedBackend(Backend):
    """A primary backend with a per-dispatch fallback; counterpart of the
    reference's ``GuardedBackend``. Opt-in only: no default picks it.

    Every seam method tries ``primary`` (default the CUDA kernels); an
    exception is recorded as a ``backend_fallback`` health event. For data
    on the CPU the call is then served by ``fallback`` (default
    ``TorchBackend``) with a warning. For data on a CUDA device nothing
    falls back: the event names no fallback and the primary's exception is
    re-raised, since the port never serves the card's tensors with a plain
    version. ``knm_quadratic`` guards building the op and every call of it.
    Not graph-safe: the try/except needs the host.
    """

    name: ClassVar[str] = "guarded"
    primary: Backend = dataclasses.field(default_factory=lambda: CudaBackend())
    fallback: Backend = dataclasses.field(default_factory=lambda: TorchBackend())

    def _refused(self, method: str, e: Exception, args: tuple) -> bool:
        """Record the primary's failure; True if the data is on a CUDA
        device (the caller re-raises), else warn that the fallback serves."""
        on_card = any(isinstance(a, Tensor) and a.is_cuda for a in args)
        health.record_event("backend_fallback", method=method, primary=self.primary.name,
                            fallback=None if on_card else self.fallback.name, error=repr(e))
        if not on_card:
            warnings.warn(f"{self.primary.name}.{method} dispatch failed ({e!r}); "
                          f"falling back to {self.fallback.name}", RuntimeWarning, stacklevel=4)
        return on_card

    def _guard(self, method: str, *args):
        try:
            return getattr(self.primary, method)(*args)
        except Exception as e:  # noqa: BLE001 — any dispatch failure falls back
            if self._refused(method, e, args):
                raise
            return getattr(self.fallback, method)(*args)

    def gram_block(self, kernel: Kernel, x: Tensor, z: Tensor) -> Tensor:
        """K(X, Z) via the primary, re-served by the fallback on failure."""
        return self._guard("gram_block", kernel, x, z)

    def masked_quadform(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                        mask: Tensor, reg: Tensor) -> Tensor:
        """Eq. 3 quadratic form with per-dispatch fallback."""
        return self._guard("masked_quadform", kernel, x_cand, z, mask, reg)

    def rls_scores(self, kernel: Kernel, x_cand: Tensor, z: Tensor,
                   z_mask: Tensor, reg: Tensor, lamn: Tensor | float) -> Tensor:
        """Eq. 3 scores with per-dispatch fallback."""
        return self._guard("rls_scores", kernel, x_cand, z, z_mask, reg, lamn)

    def knm_quadratic(self, kernel: Kernel, x: Tensor, z: Tensor, *,
                      mask: Tensor | None = None) -> KnmQuadraticOp:
        """CG quadratic op; building it and every call of it are guarded."""
        try:
            op = self.primary.knm_quadratic(kernel, x, z, mask=mask)
        except Exception as e:  # noqa: BLE001
            if self._refused("knm_quadratic", e, (x, z, mask)):
                raise
            return self.fallback.knm_quadratic(kernel, x, z, mask=mask)
        fb: list[KnmQuadraticOp | None] = [None]

        def guarded_op(v: Tensor) -> Tensor:
            try:
                return op(v)
            except Exception as e:  # noqa: BLE001
                if self._refused("knm_quadratic", e, (x, z, mask, v)):
                    raise
                if fb[0] is None:
                    fb[0] = self.fallback.knm_quadratic(kernel, x, z, mask=mask)
                return fb[0](v)

        return guarded_op

    def knm_t(self, kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *,
              mask: Tensor | None = None) -> Tensor:
        """K_nM^T y with per-dispatch fallback; ``mask`` folds into y."""
        if mask is not None:
            y = y * mask.to(y.dtype)
        return self._guard("knm_t", kernel, x, z, y)

    def knm_matvec(self, kernel: Kernel, x: Tensor, z: Tensor, v: Tensor) -> Tensor:
        """K(X, Z) v with per-dispatch fallback."""
        return self._guard("knm_matvec", kernel, x, z, v)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def require_cuda_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` as a ``torch.device``, raising ``RuntimeError`` if it names
    a CUDA device and none is present (never a silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but no CUDA device is present; "
            "ask for the CPU explicitly (FitConfig(device='cpu') or backend='torch') "
            "to run the plain torch path")
    return device


#: rows past which ``default_backend`` streams X from host memory, as the
#: reference's ``_STREAM_MIN_ROWS``; ``REPRO_STREAM_MIN_ROWS`` overrides it.
STREAM_MIN_ROWS = 1 << 21
#: rows from which a process group of more than one rank shards the data,
#: as the reference's ``_SHARD_MIN_ROWS``; ``REPRO_SHARD_MIN_ROWS`` overrides it.
SHARD_MIN_ROWS = 1 << 15


def _threshold(env: str, default: int) -> int:
    """A threshold with its environment override (empty or unset: the
    default), read at every call, as the reference's ``_threshold``."""
    raw = os.environ.get(env, "").strip()
    return int(raw) if raw else default


def _sharded(n: int | None) -> bool:
    """An initialized process group of more than one rank, and n rows
    enough to amortize its collectives."""
    from .distributed import data_group, world

    return (n is not None and n >= _threshold("REPRO_SHARD_MIN_ROWS", SHARD_MIN_ROWS)
            and world(data_group())[1] > 1)


def _plain(be: Backend | None) -> bool:
    """True if ``be`` is, or wraps through ``inner``, the plain ``TorchBackend``."""
    while be is not None:
        if isinstance(be, TorchBackend):
            return True
        be = getattr(be, "inner", None)
    return False


def _env_backend(device: torch.device | str | None, n: int | None) -> Backend | None:
    """The backend ``REPRO_BACKEND`` names (None when unset, empty or
    "auto"): a registered name or an ``"outer:inner"`` spec, resolved by
    ``resolve_backend``; anything else raises a ``ValueError`` naming the
    variable, as the reference's ``default_backend`` does. So does a spec
    that puts the plain ``TorchBackend`` under data on the card (``device``
    None or CUDA): no environment variable selects a plain version there."""
    env = os.environ.get("REPRO_BACKEND", "").strip().lower()
    if not env or env == "auto":
        return None
    from .gram import resolve_backend

    try:
        picked = resolve_backend(env, device=device, n=n)
    except ValueError as e:
        raise ValueError(f"REPRO_BACKEND={env!r}: {e}; or 'auto'") from None
    if torch.device("cuda" if device is None else device).type == "cuda" and _plain(picked):
        raise ValueError(
            f"REPRO_BACKEND={env!r} puts the plain TorchBackend under data on the card; "
            "it serves data on the CPU only (use 'cuda', 'stream', 'sharded', 'guarded' "
            "or 'auto' there)")
    return picked


def default_backend(device: torch.device | str | None = None, *,
                    n: int | None = None) -> Backend:
    """The backend named by ``REPRO_BACKEND`` if it is set; else
    ``CudaBackend`` for data on a CUDA device, and anything else raises.

    ``REPRO_BACKEND`` (the reference's knob) pins a backend without code
    edits: a registered name (``torch``, ``cuda``, ``sharded``, ``guarded``,
    ``stream``) or a composite spec (``"stream:cuda"``); ``""`` and
    ``"auto"`` fall through to the rules below, any other value raises
    ``ValueError``, as does ``torch`` (alone or as an inner, as in
    ``"stream:torch"``) for data on the card, which only the CPU's data
    runs on. A ``backend=`` the caller passes wins over it (this
    function runs only when none is given). ``GuardedBackend`` is chosen
    only by this variable or by name, never by the rules.

    ``device`` is where the data lives (None means the default, the card).
    Data on the CPU runs only when the caller names the CPU path
    (``TorchBackend`` / ``backend="torch"`` / ``FitConfig(device="cpu")``).
    ``n`` is the dataset's row count when the caller knows it: in a process
    group of more than one rank, from ``SHARD_MIN_ROWS`` rows
    (``REPRO_SHARD_MIN_ROWS``) the pick is ``ShardedBackend()`` (the CUDA
    kernels on each rank's rows); at ``STREAM_MIN_ROWS`` rows
    (``REPRO_STREAM_MIN_ROWS``) and above it is wrapped in the out-of-core
    ``StreamBackend`` (its inner backend keeps building each tile, X
    streams chunk by chunk).
    """
    picked = _env_backend(device, n)
    if picked is not None:
        return picked
    device = require_cuda_device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError(
            f"no backend is chosen by default for data on {device}; pass "
            "backend='torch' (or FitConfig(device='cpu')) to run on the CPU")
    picked = ShardedBackend() if _sharded(n) else CudaBackend()
    if n is not None and n >= _threshold("REPRO_STREAM_MIN_ROWS", STREAM_MIN_ROWS):
        from ..stream import StreamBackend

        return StreamBackend(inner=picked)
    return picked


def backend_for_device(device: torch.device | str, *, n: int | None = None) -> Backend:
    """The backend an entry point runs on ``device``: ``CudaBackend`` on a
    CUDA device (raising if none is present), ``TorchBackend`` on the CPU;
    with ``n`` rows in a process group of more than one rank (from
    ``SHARD_MIN_ROWS``), that backend on each rank's rows (``ShardedBackend``)."""
    device = require_cuda_device(device)
    be = CudaBackend() if device.type == "cuda" else TorchBackend()
    return ShardedBackend(inner=be) if _sharded(n) else be


def _stream_backend() -> Backend:
    """``StreamBackend`` factory, imported at resolve time
    (``repro_torch.stream`` imports this module)."""
    from ..stream import StreamBackend

    return StreamBackend()


register_backend("torch", TorchBackend)
register_backend("cuda", CudaBackend)
register_backend("sharded", ShardedBackend)
register_backend("guarded", GuardedBackend)
register_backend("stream", _stream_backend)
