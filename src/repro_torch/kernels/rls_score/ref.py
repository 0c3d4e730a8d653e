"""Plain PyTorch versions of K5, the fused Eq. 3 RLS score.

``fused_score_ref`` repeats the kernel's arithmetic: the masked Gram row
g_i = k(x_i, z) * zmask, the quadratic form rowsum((G W) * G) against the
given inverse W, and the epilogue (K_ii - q_i) / (lam n). ``bf16=True``
rounds the operands of the x . z term and of the G W product to bf16 and
keeps the norms, the accumulation, the product with G and the epilogue in
fp32, as the kernel does.

``masked_quadform_ref`` / ``rls_score_ref`` are the pre-fusion oracle of
the reference (``repro.kernels.rls_score.ref``): a masked Gram block, a
jittered Cholesky of the padded K_JJ + lam n A, a triangular solve and the
score epilogue as separate ops. They take a ``Kernel`` (anything with
``cross`` and ``diag``).
"""
from __future__ import annotations

import torch

from ..gram.ref import gram_ref
from ..quadform.ref import ROW_BLOCK, quadform_ref


def fused_score_ref(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor, zmask: torch.Tensor,
                    kdiag: torch.Tensor, lamn: float, inv_scale: float, *,
                    kind: str = "gaussian", bf16: bool = False,
                    block: int = ROW_BLOCK) -> torch.Tensor:
    """(K_ii - g_i^T W g_i) / (lam n) -> (R,) fp32, unclipped."""
    zm = zmask.float()[None, :]
    quad = [quadform_ref(gram_ref(x[i:i + block], z, inv_scale, kind=kind, bf16=bf16) * zm,
                         w, bf16=bf16) for i in range(0, x.shape[0], block)]
    quad = torch.cat(quad) if quad else x.new_zeros((0,), dtype=torch.float32)
    return (kdiag.float() - quad) / lamn


def _chol_jittered(a: torch.Tensor) -> torch.Tensor:
    """Eager double-jitter Cholesky (the reference's pre-fusion form)."""
    eps = 1e-6 * torch.mean(torch.diagonal(a))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a + eps * eye)
    if int(info) != 0 or bool(torch.any(torch.isnan(chol))):
        chol, _ = torch.linalg.cholesky_ex(a + (1e3 * eps) * eye)
    return chol


def masked_quadform_ref(kernel, x_cand: torch.Tensor, z: torch.Tensor, mask: torch.Tensor,
                        reg: torch.Tensor) -> torch.Tensor:
    """q_i = K_Ji^T (K_JJ * mask + diag(reg))^{-1} K_Ji, via one trsm."""
    m = mask.to(z.dtype)
    kjj = kernel.cross(z, z) * (m[:, None] * m[None, :]) + torch.diag(reg.to(z.dtype))
    g = kernel.cross(x_cand, z) * m[None, :]
    v = torch.linalg.solve_triangular(_chol_jittered(kjj), g.T, upper=False)
    return torch.sum(v * v, dim=0)


def rls_score_ref(kernel, x_cand: torch.Tensor, z: torch.Tensor, mask: torch.Tensor,
                  reg: torch.Tensor, lamn) -> torch.Tensor:
    """Eq. 3 scores (K_ii - q_i) / (lam n), unclipped and unmasked.

    ``z`` (Mbuf, d) padded centers, ``mask`` (Mbuf,) validity, ``reg``
    (Mbuf,) the regularized diagonal (lam n A on valid slots, 1 on padding),
    ``lamn`` the scalar lam * n. Returns (Rbuf,).
    """
    return (kernel.diag(x_cand) - masked_quadform_ref(kernel, x_cand, z, mask, reg)) / lamn
