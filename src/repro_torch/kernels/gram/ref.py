"""Plain PyTorch version of K1 (the Gram kernel): same math as the CUDA tile.

``bf16=True`` rounds only the operands of the x . z term to bf16 and keeps
the product, the norms and the epilogue in fp32, as the kernel does.
"""
from __future__ import annotations

import torch

from ...families import get_family


def cross_term(x: torch.Tensor, z: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x . z^T in fp32, from bf16-rounded operands when ``bf16``."""
    if bf16:
        x = x.to(torch.bfloat16).float()
        z = z.to(torch.bfloat16).float()
    return x @ z.T


def gram_ref(x: torch.Tensor, z: torch.Tensor, inv_scale: float, *, kind: str = "gaussian",
             bf16: bool = False) -> torch.Tensor:
    """k(X, Z) (n, m) fp32."""
    fam = get_family(kind)
    x = x.float()
    z = z.float()
    prod = cross_term(x, z, bf16)
    if fam.dot_only:
        return fam.epilogue(prod, inv_scale)
    d2 = torch.clamp(torch.sum(x * x, -1)[:, None] + torch.sum(z * z, -1)[None, :]
                     - 2.0 * prod, min=0.0)
    return fam.epilogue(d2, inv_scale)
