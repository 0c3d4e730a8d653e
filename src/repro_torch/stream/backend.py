"""``StreamBackend``: the full ``Backend`` protocol over chunked host data.

The PyTorch counterpart of ``repro.stream.backend``. Every K_nM-shaped
contraction is a double-buffered loop over ``device_chunks``: while chunk
i's (chunk, M) Gram tile is built and contracted on the device, the copy of
chunk i+1 is already in flight. The tile is consumed at once, reduced into
the (M,) / (M, k) accumulator (``knm_quadratic`` / ``knm_t``), the (R,)
score vector (``masked_quadform`` / ``rls_scores``) or the (n,) / (n, k)
prediction (``knm_matvec``), so no (n, M) array ever exists.
``gram_block`` is the one method whose output is (n, m); it raises past
``materialize_elems`` rather than materialize an out-of-core block.

Composition, as in the reference: each tile comes from ``inner.gram_block``
(K1 on ``CudaBackend``, the plain torch formula on ``TorchBackend``), and
its products with the iterate, targets or factor are ``torch.matmul`` /
``solve_triangular``, computed outside any kernel as the JAX package
computes them outside any Pallas kernel. The registry spells the
composition ``"stream:cuda"`` / ``"stream:torch"``.

Accumulation order is the chunk order, fixed: repeated calls on the same
data give bit-identical results. The sums associate differently from the
non-streamed backends' (``chunk``-row chunks against their row blocks), so
cross-backend agreement is the 1e-4 scale-relative parity, not equality.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ..core.backend import Backend, CudaBackend, KnmQuadraticOp
from ..core.gram import Kernel
from ..core.leverage import _chol_with_jitter
from .store import _TRACKER, device_chunks

Tensor = torch.Tensor

#: ``gram_block`` materialization guard: refuse outputs above this many fp32
#: elements (2^26 = 256 MB), as the reference does.
MATERIALIZE_ELEMS = 1 << 26


def _quadform_from_chol(chol: Tensor, g: Tensor) -> Tensor:
    """rowsum(solve(L, g^T)^2): q_i = g_i^T (L L^T)^{-1} g_i."""
    v = torch.linalg.solve_triangular(chol, g.T, upper=False)
    return torch.sum(v * v, dim=0)


def _cat(parts: list[Tensor]) -> Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class StreamBackend(Backend):
    """Out-of-core streaming backend (see module docstring).

    Attributes:
      inner: the backend that builds each (chunk, M) Gram tile;
        ``CudaBackend`` (K1) by default, ``TorchBackend`` via
        ``"stream:torch"``.
      chunk: rows per device chunk; None defers to the ``ChunkStore``'s own
        chunk size (or the device default for tensors).
      materialize_elems: the ``gram_block`` output-size guard (elements).
    """

    name: ClassVar[str] = "stream"
    inner: Backend = dataclasses.field(default_factory=CudaBackend)
    chunk: int | None = None
    materialize_elems: int = MATERIALIZE_ELEMS

    def with_inner(self, inner: Backend) -> "StreamBackend":
        """This wrapper with its per-tile backend swapped: the composition
        hook ``resolve_backend`` uses for ``"stream:<inner>"`` specs."""
        return dataclasses.replace(self, inner=inner)

    def _chunks(self, x, z: Tensor, aux=None):
        """``device_chunks`` onto the centers' device, noting each tile."""
        for xb, ab in device_chunks(x, aux, chunk=self.chunk, device=z.device):
            _TRACKER.note_transient(4 * xb.shape[0] * z.shape[0])
            yield xb, ab

    def _factor(self, kernel: Kernel, z: Tensor, mask: Tensor, reg: Tensor):
        """(mask as fp32, Cholesky of K_JJ * mask + diag(reg)), hoisted out of
        the chunk loop."""
        m = mask.to(torch.float32)
        kjj = (self.inner.gram_block(kernel, z, z) * (m[:, None] * m[None, :])
               + torch.diag(reg.to(torch.float32)))
        return m, _chol_with_jitter(kjj)

    # -- protocol -----------------------------------------------------------

    def gram_block(self, kernel: Kernel, x, z: Tensor) -> Tensor:
        """K(X, Z) (n, m) fp32, streamed chunk by chunk through the inner
        backend; raises if the output exceeds ``materialize_elems``."""
        n, m = x.shape[0], z.shape[0]
        if n * m > self.materialize_elems:
            raise ValueError(
                f"stream backend refuses to materialize a ({n}, {m}) Gram "
                f"block ({n * m} > materialize_elems={self.materialize_elems}"
                "); out-of-core problems must go through the knm_* / "
                "quadform operators, which never build (n, M), or raise "
                "StreamBackend(materialize_elems=...) if this block is "
                "genuinely meant to exist")
        return _cat([self.inner.gram_block(kernel, xb, z) for xb, _ in self._chunks(x, z)])

    def masked_quadform(self, kernel: Kernel, x_cand, z: Tensor, mask: Tensor,
                        reg: Tensor) -> Tensor:
        """Eq. 3 quadratic form: K_JJ factored once, then one triangular
        solve per candidate chunk."""
        m, chol = self._factor(kernel, z, mask, reg)
        return _cat([_quadform_from_chol(chol, self.inner.gram_block(kernel, xb, z) * m[None, :])
                     for xb, _ in self._chunks(x_cand, z)])

    def rls_scores(self, kernel: Kernel, x_cand, z: Tensor, z_mask: Tensor,
                   reg: Tensor, lamn: Tensor | float) -> Tensor:
        """Eq. 3 scores with the K_JJ factorization hoisted out of the chunk
        loop (the inner backend's own scorer would refactor it per chunk)."""
        m, chol = self._factor(kernel, z, z_mask, reg)
        return _cat([(kernel.diag(xb) - _quadform_from_chol(
            chol, self.inner.gram_block(kernel, xb, z) * m[None, :])) / lamn
            for xb, _ in self._chunks(x_cand, z)])

    def knm_quadratic(self, kernel: Kernel, x, z: Tensor, *,
                      mask: Tensor | None = None) -> KnmQuadraticOp:
        """CG quadratic op v -> K_nM^T (K_nM v): every call re-streams X,
        folding each (chunk, M) tile into the accumulator in chunk order. An
        optional ``mask`` ((n,) or (n, k)) rides the chunk iterator as the
        aux stream."""

        def op(v: Tensor) -> Tensor:
            acc = v.new_zeros((z.shape[0],) + tuple(v.shape[1:]))
            for xb, mb in self._chunks(x, z, mask):
                g = self.inner.gram_block(kernel, xb, z)
                t = g @ v
                if mb is not None:
                    mb = mb.to(t.dtype)
                    t = t * (mb if t.ndim == mb.ndim else mb[:, None])
                acc = acc + g.T @ t
            return acc

        return op

    def knm_t(self, kernel: Kernel, x, z: Tensor, y: Tensor, *,
              mask: Tensor | None = None) -> Tensor:
        """K_nM^T y with y chunked in lockstep with X; (n,) -> (M,) or
        (n, k) -> (M, k). ``mask`` folds into the targets first."""
        if mask is not None:
            y = y * mask.to(device=y.device, dtype=y.dtype)
        acc = torch.zeros((z.shape[0],) + tuple(y.shape[1:]), dtype=torch.float32,
                          device=z.device)
        for xb, yb in self._chunks(x, z, y):
            acc = acc + self.inner.gram_block(kernel, xb, z).T @ yb
        return acc

    def knm_matvec(self, kernel: Kernel, x, z: Tensor, v: Tensor) -> Tensor:
        """K(X, Z) v, predict: per-chunk outputs concatenated to (n,) or
        (n, k), the only O(n) device tensor this path makes."""
        return _cat([self.inner.gram_block(kernel, xb, z) @ v for xb, _ in self._chunks(x, z)])
