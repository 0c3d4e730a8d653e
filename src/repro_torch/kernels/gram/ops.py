"""Public wrapper of K1: k(X, Z) through the CUDA kernel or its plain version.

A CUDA tensor goes to the kernel (``gram.cu``) or the call raises; a CPU
tensor goes to the plain version (``ref.py``). ``gram.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import torch

from ...families import get_family
from .. import build
from ..common import is_cpu, require_cuda
from .ref import gram_ref



def cuda_family_id(kind: str) -> int:
    """The family's id in the CUDA epilogue switch; raises for a family
    registered without one."""
    fam = get_family(kind)
    if fam.cuda_id is None:
        raise NotImplementedError(f"kernel family {kind!r} has no CUDA epilogue "
                                  "(KernelFamily.cuda_id is None)")
    return fam.cuda_id


def gram(x: torch.Tensor, z: torch.Tensor, sigma: float = 1.0, *, kind: str = "gaussian",
         bf16: bool = False) -> torch.Tensor:
    """k(X, Z) -> (n, m) fp32 for x (n, d) and z (m, d) of any shape.

    ``bf16`` rounds the operands of the x . z term to bf16 (fp32
    accumulation; norms and epilogue fp32).
    """
    inv_scale = float(get_family(kind).inv_scale(sigma))
    if x.shape[1] != z.shape[1]:
        raise ValueError(f"feature dims differ: x {tuple(x.shape)}, z {tuple(z.shape)}")
    if is_cpu(x, z):
        return gram_ref(x, z, inv_scale, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x = require_cuda(x, "x")
    z = require_cuda(z, "z")
    n, d = x.shape
    m = z.shape[0]
    if d < 1:
        raise ValueError("the CUDA kernels need at least one feature")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    build.extension().gram(x, z, out, fam_id, inv_scale, bf16)
    gram.launches += 1
    return out


gram.launches = 0


def gram_reference(x: torch.Tensor, z: torch.Tensor, sigma: float = 1.0, *,
                   kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """The plain version at the wrapper's signature (any device)."""
    return gram_ref(x, z, float(get_family(kind).inv_scale(sigma)), kind=kind, bf16=bf16)
