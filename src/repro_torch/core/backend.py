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
    what ``FitConfig(device="cpu")`` runs.
  * ``CudaBackend``  — the hand-written CUDA kernels, counterpart of
    ``PallasBackend``: ``gram_block`` is K1, ``knm_quadratic`` K2 (with a
    ``mask=`` panel the row-masked K7), ``knm_t`` K3 (a mask folds into the
    targets first), ``knm_matvec`` K4, ``rls_scores`` the fused Eq. 3 score
    K5 (up to ``MAX_FUSED_M`` centers) and ``masked_quadform`` K1 + the
    quadratic form K6.

Backends are frozen dataclasses: hashable and comparable by configuration.
Selection is by instance, by registry name ("torch" | "cuda" | "stream",
or a composite "stream:<inner>"), or None for ``default_backend(device)``,
which picks ``CudaBackend`` for data on a CUDA device (the out-of-core
``StreamBackend`` around it past ``REPRO_STREAM_MIN_ROWS`` rows) and raises
for data elsewhere: the CPU path is taken only when the caller names it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, ClassVar

import torch

from ..kernels.falkon_matvec import ops as falkon_ops
from ..kernels.gram import ops as gram_ops
from ..kernels.quadform import ops as quadform_ops
from ..kernels.rls_score import ops as rls_ops
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
#: reference's ``_STREAM_MIN_ROWS``. ``REPRO_STREAM_MIN_ROWS`` overrides it
#: only for parity with the reference's documented knob (same name, same
#: default); nothing in the port sets it.
STREAM_MIN_ROWS = 1 << 21


def _stream_min_rows() -> int:
    env = os.environ.get("REPRO_STREAM_MIN_ROWS", "").strip()
    return int(env) if env else STREAM_MIN_ROWS


def default_backend(device: torch.device | str | None = None, *,
                    n: int | None = None) -> Backend:
    """``CudaBackend`` for data on a CUDA device; anything else raises.

    ``device`` is where the data lives (None means the default, the card).
    Data on the CPU runs only when the caller names the CPU path
    (``TorchBackend`` / ``backend="torch"`` / ``FitConfig(device="cpu")``).
    ``n`` is the dataset's row count when the caller knows it: at
    ``REPRO_STREAM_MIN_ROWS`` rows and above the pick is wrapped in the
    out-of-core ``StreamBackend`` (K1 keeps building each tile, X streams
    chunk by chunk).
    """
    device = require_cuda_device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError(
            f"no backend is chosen by default for data on {device}; pass "
            "backend='torch' (or FitConfig(device='cpu')) to run on the CPU")
    if n is not None and n >= _stream_min_rows():
        from ..stream import StreamBackend

        return StreamBackend(inner=CudaBackend())
    return CudaBackend()


def backend_for_device(device: torch.device | str) -> Backend:
    """The backend an entry point runs on ``device``: ``CudaBackend`` on a
    CUDA device (raising if none is present), ``TorchBackend`` on the CPU."""
    device = require_cuda_device(device)
    return CudaBackend() if device.type == "cuda" else TorchBackend()


def _stream_backend() -> Backend:
    """``StreamBackend`` factory, imported at resolve time
    (``repro_torch.stream`` imports this module)."""
    from ..stream import StreamBackend

    return StreamBackend()


register_backend("torch", TorchBackend)
register_backend("cuda", CudaBackend)
register_backend("stream", _stream_backend)
