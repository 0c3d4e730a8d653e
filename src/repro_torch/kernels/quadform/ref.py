"""Plain PyTorch version of K6: s_i = rowsum((G W) * G), same math as the
CUDA kernel.

``bf16=True`` rounds the two operands of the G W product to bf16 and keeps
the accumulation, the elementwise product with the unrounded G and the row
sum in fp32, as the kernel does. G is taken in row blocks, so the (block, m)
product G W is the largest intermediate.
"""
from __future__ import annotations

import torch

#: rows of G per block of the plain version.
ROW_BLOCK = 8192


def _round(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if bf16 else t


def quadform_ref(g: torch.Tensor, w: torch.Tensor, *, bf16: bool = False,
                 block: int = ROW_BLOCK) -> torch.Tensor:
    """rowsum((G W) * G) -> (n,) fp32 for G (n, m), W (m, m)."""
    g = g.float()
    w = _round(w.float(), bf16)
    parts = [torch.sum((_round(g[i:i + block], bf16) @ w) * g[i:i + block], dim=1)
             for i in range(0, g.shape[0], block)]
    return torch.cat(parts) if parts else g.new_zeros((0,))
