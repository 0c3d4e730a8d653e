"""Streamed normal-equation accumulators for durable and online FALKON.

The PyTorch counterpart of ``repro.online.accumulate``. One deterministic
chunk-order pass over the data accumulates

    H = K_nM^T K_nM   (M, M)        b = K_nM^T y   (M,) or (M, k)

and the fit then solves (H + lam n K_MM) alpha = b with the paper's Def. 2
preconditioner and the shared multi-RHS CG of ``repro_torch.core.falkon``:

  * checkpointable: (H, b, cursor) at a chunk barrier is the whole fit
    state, and fp32 ``.npy`` round trips are bit-exact;
  * incremental: new rows fold in as H += G^T G, b += G^T y;
  * warm refits cost O(M^2 iters), independent of n.

Each chunk's G is ``inner.gram_block`` (K1 on ``CudaBackend``); the two
products are ``torch.matmul`` / ``addmm`` on the consumer's stream at fixed
shapes, with no atomics and no split-K reduction, so the same chunks in the
same order give the same bits, which is what makes a resumed durable fit
bit-identical on the card too.

The accumulators are fp64 (``ACC_DTYPE``) where the reference's are fp32:
G stays fp32 (K1), and is widened before the two products, so H carries
fp64 rounding. In fp32 the rounding of H, about eps * ||H||, exceeds
lam n once n M is large and lam small (at n = 10^6, M = 2 980,
lam = 1e-6 it is ~36 against lam n = 1): H + lam n K_MM turns indefinite in
the directions the preconditioner amplifies, and CG on it diverged to a
non-finite alpha on the card. The solve runs in fp64 and returns an fp32
alpha. Accumulators handed in keep their own dtype.

The reference counts jit traces of its fused solve (``_ACC_SOLVE_TRACES``);
torch compiles nothing here, so the port has no such counter.
"""
from __future__ import annotations

import torch

from ..core.falkon import cg, make_preconditioner
from ..core.gram import BackendLike, Kernel, resolve_backend
from ..stream.store import _TRACKER, device_chunks

Tensor = torch.Tensor

#: dtype of the H and b accumulators that durable and online fits keep.
ACC_DTYPE = torch.float64


def absorb(kernel: Kernel, x, y, z: Tensor, h: Tensor, b: Tensor, *, inner,
           chunk: int | None = None) -> tuple[Tensor, Tensor]:
    """Fold rows (x, y) into the accumulators, chunk by chunk in row order.

    ``x`` / ``y`` may be a ``ChunkStore``'s rows, host tensors or numpy
    arrays (copied to the centers' device chunk by chunk), or tensors
    already there. G is widened to the accumulators' dtype before the
    products. Returns the new (H, b); the inputs are not written.
    """
    for xb, yb in device_chunks(x, y, chunk=chunk, device=z.device):
        _TRACKER.note_transient(4 * xb.shape[0] * z.shape[0])
        g = inner.gram_block(kernel, xb, z).to(h.dtype)
        h = torch.addmm(h, g.T, g)
        b = b + g.T @ yb.to(b.dtype)
    return h, b


def solve_accumulators(kernel: Kernel, h: Tensor, b: Tensor, centers: Tensor,
                       lam: float, n: int, *, a_diag: Tensor | None = None,
                       iters: int = 20,
                       backend: BackendLike = None) -> tuple[Tensor, Tensor]:
    """Solve (H + lam n K_MM) alpha = b; returns (alpha, CG residuals).

    K_MM comes from ``backend`` (K1 on the card, as ``falkon_fit`` builds
    it) and feeds the Def. 2 preconditioner; everything is (M, M)-sized,
    with no pass over the data. The preconditioner and CG run in the wider
    of the accumulators' dtype and fp32; alpha comes back fp32.
    """
    be = resolve_backend(backend, device=centers.device)
    m = centers.shape[0]
    a_diag = (torch.ones((m,), dtype=torch.float32, device=centers.device) if a_diag is None
              else a_diag.to(device=centers.device, dtype=torch.float32))
    dtype = torch.promote_types(h.dtype, torch.float32)
    kmm = be.gram_block(kernel, centers, centers).to(dtype)
    prec = make_preconditioner(kernel, centers, a_diag, lam, n, kmm=kmm)
    lam_n = float(lam) * n
    h, b = h.to(dtype), b.to(dtype)

    def matvec(v: Tensor) -> Tensor:
        u = prec.apply(v)
        return prec.apply_t(h @ u + lam_n * (kmm @ u))

    beta, resid = cg(matvec, prec.apply_t(b), iters, trajectory=True)
    return prec.apply(beta).float(), resid
