"""Plain PyTorch versions of K2-K4 and K7, the FALKON K_nM contractions.

Same math as the CUDA kernels: the Gram block is ``gram_ref`` (bf16 only on
the x . z operands), contracted in fp32. X is taken in row blocks of
``block`` rows so K_nM is never stored whole, here either; ``knm_t`` and
``falkon_matvec`` add the blocks' contributions in row order. ``v``, ``y``
and ``alpha`` may be vectors or (., k) panels; the mask of
``falkon_matvec_masked_ref`` is shaped like a length-n slice of ``v``.
"""
from __future__ import annotations

import torch

from ..gram.ref import gram_ref

#: rows of X per Gram block (a (block, M) fp32 block at M = 10^4 is 328 MB).
ROW_BLOCK = 8192


def falkon_matvec_ref(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, inv_scale: float,
                      *, kind: str = "gaussian", bf16: bool = False,
                      block: int = ROW_BLOCK) -> torch.Tensor:
    """K_nM^T (K_nM v) -> (M,) or (M, k)."""
    v = v.float()
    out = v.new_zeros((z.shape[0],) + tuple(v.shape[1:]))
    for i in range(0, x.shape[0], block):
        g = gram_ref(x[i:i + block], z, inv_scale, kind=kind, bf16=bf16)
        out += g.T @ (g @ v)
    return out


def falkon_matvec_masked_ref(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor,
                             mask: torch.Tensor, inv_scale: float, *, kind: str = "gaussian",
                             bf16: bool = False, block: int = ROW_BLOCK) -> torch.Tensor:
    """Column j of K_nM^T diag(mask[:, j]) K_nM v_j -> (M,) or (M, k); ``mask``
    is (n,) with a vector ``v`` or (n, k) with a panel."""
    v = v.float()
    mask = mask.float()
    out = v.new_zeros((z.shape[0],) + tuple(v.shape[1:]))
    for i in range(0, x.shape[0], block):
        g = gram_ref(x[i:i + block], z, inv_scale, kind=kind, bf16=bf16)
        out += g.T @ ((g @ v) * mask[i:i + block])
    return out


def knm_t_ref(x: torch.Tensor, z: torch.Tensor, y: torch.Tensor, inv_scale: float,
              *, kind: str = "gaussian", bf16: bool = False,
              block: int = ROW_BLOCK) -> torch.Tensor:
    """K_nM^T y -> (M,) or (M, k)."""
    y = y.float()
    out = y.new_zeros((z.shape[0],) + tuple(y.shape[1:]))
    for i in range(0, x.shape[0], block):
        g = gram_ref(x[i:i + block], z, inv_scale, kind=kind, bf16=bf16)
        out += g.T @ y[i:i + block]
    return out


def knm_matvec_ref(x: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, inv_scale: float,
                   *, kind: str = "gaussian", bf16: bool = False,
                   block: int = ROW_BLOCK) -> torch.Tensor:
    """K_nM alpha -> (n,) or (n, k)."""
    alpha = alpha.float()
    parts = [gram_ref(x[i:i + block], z, inv_scale, kind=kind, bf16=bf16) @ alpha
             for i in range(0, x.shape[0], block)]
    if not parts:
        return alpha.new_zeros((0,) + tuple(alpha.shape[1:]))
    return torch.cat(parts)
