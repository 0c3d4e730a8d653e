"""Public wrapper of K5, the fused Eq. 3 score (K_ii - g_i^T W g_i) / (lam n).

Any R, M <= ``MAX_FUSED_M`` and d: nothing is padded, the kernel masks the
ragged edges itself. K_ii comes from the family's diagonal (the plain version
forms it as the reference wrapper does; the kernels apply the family's
epilogue to the same pre-activation). A CUDA tensor goes to the kernels of
``rls_score.cu`` (through the extension ``build.py`` loads) or the call
raises: the fused
kernel writes one partial quadratic form per ``TILE``-column tile of W into
a (max(1, ceil(M / TILE)), R) scratch, and a second kernel adds them in
order and applies the score epilogue. A CPU tensor goes to the plain version
in ``ref.py``. ``rls_score.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from ...families import diag_pre, get_family
from .. import build
from ..common import is_cpu, require_cuda
from ..gram.ops import cuda_family_id
from .ref import fused_score_ref

#: Largest center buffer the fused kernel takes (``rls_score/ops.py:21`` of
#: the reference). Its (32, M) Gram slab lives in shared memory (132 KB at
#: 1024); above it ``CudaBackend`` composes K1 + K6 instead.
MAX_FUSED_M = 1024
TILE = 128  # W columns per block (rls_score.cu's SN)


def _check(x_cand, z, w, zmask) -> None:
    if (x_cand.ndim != 2 or z.ndim != 2 or x_cand.shape[1] != z.shape[1]
            or w.shape != (z.shape[0], z.shape[0]) or zmask.shape != (z.shape[0],)):
        raise ValueError(f"need x_cand (R, d), z (M, d), w (M, M), zmask (M,); got "
                         f"{tuple(x_cand.shape)}, {tuple(z.shape)}, {tuple(w.shape)}, "
                         f"{tuple(zmask.shape)}")


def _plain(x_cand, z, w, zmask, lamn, sigma, kind, bf16) -> torch.Tensor:
    """The plain version, K_ii from the family's diagonal as the reference
    wrapper forms it."""
    fam = get_family(kind)
    inv_scale = float(fam.inv_scale(sigma))
    kdiag = fam.epilogue(diag_pre(fam, x_cand.float()), inv_scale).float()
    return fused_score_ref(x_cand, z, w, zmask, kdiag, float(lamn), inv_scale, kind=kind,
                           bf16=bf16)


def rls_score(x_cand: torch.Tensor, z: torch.Tensor, w: torch.Tensor, zmask: torch.Tensor,
              lamn, sigma: float = 1.0, *, kind: str = "gaussian",
              bf16: bool = False) -> torch.Tensor:
    """Eq. 3 scores (K_ii - g_i^T W g_i) / (lam n) for each candidate row.

    x_cand (R, d), z (M, d) padded centers, w (M, M) the inverse of the
    regularized K_JJ, zmask (M,) center validity, lamn the scalar lam * n.
    Returns (R,) fp32, unclipped. ``bf16`` rounds the operands of the
    x . z term and of G W (fp32 accumulation and epilogue).
    """
    _check(x_cand, z, w, zmask)
    if is_cpu(x_cand, z, w, zmask):
        return _plain(x_cand, z, w, zmask, lamn, sigma, kind, bf16)
    fam_id = cuda_family_id(kind)
    inv_scale = float(get_family(kind).inv_scale(sigma))
    if z.shape[0] > MAX_FUSED_M:
        raise ValueError(f"the fused kernel takes at most {MAX_FUSED_M} centers, got "
                         f"{z.shape[0]}; compose gram + quadform above that")
    if x_cand.shape[1] < 1:
        raise ValueError("the CUDA kernels need at least one feature")
    x_cand = require_cuda(x_cand, "x_cand")
    z = require_cuda(z, "z")
    w = require_cuda(w, "w")
    zm = require_cuda(zmask.float(), "zmask")
    out = torch.empty((x_cand.shape[0],), dtype=torch.float32, device=x_cand.device)
    if x_cand.shape[0] == 0:
        return out
    partial = torch.empty((max(1, -(-z.shape[0] // TILE)), x_cand.shape[0]),
                          dtype=torch.float32, device=x_cand.device)
    build.extension().rls_score(x_cand, z, w, zm, partial, out, fam_id, inv_scale, float(lamn),
                                bf16)
    rls_score.launches += 1
    return out


rls_score.launches = 0


def rls_score_reference(x_cand, z, w, zmask, lamn, sigma: float = 1.0, *,
                        kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """The plain K5 at the wrapper's signature (any device)."""
    _check(x_cand, z, w, zmask)
    return _plain(x_cand, z, w, zmask, lamn, sigma, kind, bf16)
