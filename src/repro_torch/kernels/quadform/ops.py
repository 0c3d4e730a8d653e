"""Public wrapper of K6, the fused quadratic form rowsum((G W) * G).

Any n and m: nothing is padded, the kernel masks the ragged edges itself. A
CUDA tensor goes to the kernels of ``quadform.cu`` (through the extension
``build.py`` loads) or the call raises; a CPU tensor goes to the plain
version in ``ref.py``. ``quadform.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import is_cpu, require_cuda
from .ref import quadform_ref

TILE = 64  # rows of G and columns of W per block (quadform.cu)


def _check(g: torch.Tensor, w: torch.Tensor) -> None:
    if g.ndim != 2 or w.ndim != 2 or w.shape != (g.shape[1], g.shape[1]):
        raise ValueError(f"need G (n, m) and W (m, m); got {tuple(g.shape)}, {tuple(w.shape)}")


def quadform(g: torch.Tensor, w: torch.Tensor, *, bf16: bool = False) -> torch.Tensor:
    """s_i = g_i^T W g_i for each row of G (n, m), W (m, m) -> (n,) fp32.

    ``bf16`` rounds the operands of the G W product to bf16 (fp32
    accumulation; the product with G and the row sum stay fp32).
    """
    _check(g, w)
    if is_cpu(g, w):
        return quadform_ref(g, w, bf16=bf16)
    g = require_cuda(g, "g")
    w = require_cuda(w, "w")
    n, m = g.shape
    out = torch.empty((n,), dtype=torch.float32, device=g.device)
    if n == 0 or m == 0:
        return out.zero_()
    partial = torch.empty((-(-m // TILE), n), dtype=torch.float32, device=g.device)
    build.extension().quadform(g, w, partial, out, bf16)
    quadform.launches += 1
    return out


quadform.launches = 0


def quadform_reference(g: torch.Tensor, w: torch.Tensor, *, bf16: bool = False) -> torch.Tensor:
    """The plain K6 at the wrapper's signature (any device)."""
    _check(g, w)
    return quadform_ref(g, w, bf16=bf16)
