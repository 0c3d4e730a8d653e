"""Public wrappers of K2-K4 and K7, the fused FALKON K_nM contractions.

``falkon_matvec`` (K_nM^T K_nM V, the CG quadratic op), ``knm_t`` (K_nM^T Y,
the CG right-hand sides) and ``knm_matvec`` (K_nM A, predict) take a single
vector or an (., k) panel and any n, M, d, k: nothing is padded, the kernels
mask the ragged edges themselves. ``falkon_matvec(mask=...)`` goes to
``falkon_matvec_masked`` (K7, the row-masked quadratic op of exact k-fold
CV). A CUDA tensor goes to the kernels of
``falkon_matvec.cu`` (through the extension ``build.py`` loads) or the call
raises; a CPU tensor goes to the plain version in ``ref.py``. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from ...families import get_family
from .. import build
from ..common import is_cpu, require_cuda
from ..gram.ops import cuda_family_id
from .ref import falkon_matvec_masked_ref, falkon_matvec_ref, knm_matvec_ref, knm_t_ref

TILE = 64  # the kernels' Gram tile edge (gram_tile.cuh)
#: blocks the row-chunked reductions aim to launch (a few waves of 132 SMs).
TARGET_BLOCKS = 2048


def row_chunks(n: int, m: int) -> tuple[int, int]:
    """(n_chunks, chunk_rows) of the two-stage K_nM^T reduction.

    Each (center tile, row chunk) block sums its rows in order; the chunks
    are then added in index order. The split depends on (n, M) alone, so a
    given problem always sums in the same order (bit-repeatable).
    """
    m_tiles = max(1, -(-m // TILE))
    n_tiles = max(1, -(-n // TILE))
    want = min(max(1, -(-TARGET_BLOCKS // m_tiles)), n_tiles, 65535)
    chunk_rows = -(-n_tiles // want) * TILE
    return max(1, -(-n // chunk_rows)), chunk_rows


def _inv_scale(kind: str, sigma: float) -> float:
    return float(get_family(kind).inv_scale(sigma))


def _as_panel(v: torch.Tensor, rows: int, what: str) -> tuple[torch.Tensor, bool]:
    if v.ndim not in (1, 2) or v.shape[0] != rows:
        raise ValueError(f"{what} must be ({rows},) or ({rows}, k), got {tuple(v.shape)}")
    squeeze = v.ndim == 1
    return require_cuda(v[:, None] if squeeze else v, what), squeeze


def _check_xz(x: torch.Tensor, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1] or x.shape[1] < 1:
        raise ValueError(f"need x (n, d), z (M, d) with d >= 1; got {tuple(x.shape)}, "
                         f"{tuple(z.shape)}")
    return require_cuda(x, "x"), require_cuda(z, "z")


def falkon_matvec(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, sigma: float = 1.0, *,
                  kind: str = "gaussian", bf16: bool = False,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """K_nM^T (K_nM v) -> (M,) or (M, k) fp32 (K2).

    ``mask`` -- optional per-column row weights, (n,) or, with a panel ``v``,
    (n, k): column j then computes K_nM^T diag(mask[:, j]) K_nM v_j through
    ``falkon_matvec_masked`` (K7). ``mask=None`` is K2 unchanged.
    """
    if mask is not None:
        return falkon_matvec_masked(x, z, v, mask, sigma, kind=kind, bf16=bf16)
    s = _inv_scale(kind, sigma)
    if is_cpu(x, z, v):
        return falkon_matvec_ref(x, z, v, s, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x, z = _check_xz(x, z)
    vp, squeeze = _as_panel(v, z.shape[0], "v")
    n = x.shape[0]
    m, k = vp.shape
    n_chunks, chunk_rows = row_chunks(n, m)
    t = torch.empty((n, k), dtype=torch.float32, device=x.device)
    partial = torch.empty((n_chunks, m, k), dtype=torch.float32, device=x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    build.extension().falkon_matvec(x, z, vp, t, partial, out, chunk_rows, fam_id, s, bf16)
    falkon_matvec.launches += 1
    return out[:, 0] if squeeze else out


def _as_mask(mask: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The mask as the reference normalises it: an (n,) mask with a panel
    ``v`` is broadcast to (n, k); then fp32 and contiguous."""
    if mask.ndim == 1 and v.ndim == 2:
        mask = mask[:, None].expand(mask.shape[0], v.shape[1])
    want = (x.shape[0],) + tuple(v.shape[1:])
    if tuple(mask.shape) != want:
        raise ValueError(f"mask must be {want} for v of shape {tuple(v.shape)} (or ({x.shape[0]},) "
                         f"with a panel), got {tuple(mask.shape)}")
    return mask.to(torch.float32).contiguous()


def falkon_matvec_masked(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                         sigma: float = 1.0, *, kind: str = "gaussian",
                         bf16: bool = False) -> torch.Tensor:
    """Column j of K_nM^T diag(mask[:, j]) K_nM v_j -> (M,) or (M, k) fp32 (K7).

    ``mask`` is (n,) with a vector ``v``, or (n, k) or (n,) with a panel.
    """
    s = _inv_scale(kind, sigma)
    mask = _as_mask(mask, x, v)
    if is_cpu(x, z, v, mask):
        return falkon_matvec_masked_ref(x, z, v, mask, s, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x, z = _check_xz(x, z)
    vp, squeeze = _as_panel(v, z.shape[0], "v")
    mp = mask[:, None] if squeeze else mask
    n = x.shape[0]
    m, k = vp.shape
    n_chunks, chunk_rows = row_chunks(n, m)
    t = torch.empty((n, k), dtype=torch.float32, device=x.device)
    partial = torch.empty((n_chunks, m, k), dtype=torch.float32, device=x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    build.extension().falkon_matvec_masked(x, z, vp, mp, t, partial, out, chunk_rows, fam_id, s,
                                           bf16)
    falkon_matvec_masked.launches += 1
    return out[:, 0] if squeeze else out


def knm_t(x: torch.Tensor, z: torch.Tensor, y: torch.Tensor, sigma: float = 1.0, *,
          kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """K_nM^T y -> (M,) or (M, k) fp32 (K3)."""
    s = _inv_scale(kind, sigma)
    if is_cpu(x, z, y):
        return knm_t_ref(x, z, y, s, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x, z = _check_xz(x, z)
    yp, squeeze = _as_panel(y, x.shape[0], "y")
    n = x.shape[0]
    m, k = z.shape[0], yp.shape[1]
    n_chunks, chunk_rows = row_chunks(n, m)
    partial = torch.empty((n_chunks, m, k), dtype=torch.float32, device=x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    build.extension().knm_t(x, z, yp, partial, out, chunk_rows, fam_id, s, bf16)
    knm_t.launches += 1
    return out[:, 0] if squeeze else out


def knm_matvec(x: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, sigma: float = 1.0, *,
               kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """K_nM alpha -> (n,) or (n, k) fp32 (K4)."""
    s = _inv_scale(kind, sigma)
    if is_cpu(x, z, alpha):
        return knm_matvec_ref(x, z, alpha, s, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x, z = _check_xz(x, z)
    ap, squeeze = _as_panel(alpha, z.shape[0], "alpha")
    out = torch.empty((x.shape[0], ap.shape[1]), dtype=torch.float32, device=x.device)
    build.extension().knm_matvec(x, z, ap, out, fam_id, s, bf16)
    knm_matvec.launches += 1
    return out[:, 0] if squeeze else out


falkon_matvec.launches = 0
falkon_matvec_masked.launches = 0
knm_t.launches = 0
knm_matvec.launches = 0


def falkon_matvec_reference(x, z, v, sigma: float = 1.0, *, kind: str = "gaussian",
                            bf16: bool = False) -> torch.Tensor:
    """The plain K2 at the wrapper's signature (any device)."""
    return falkon_matvec_ref(x, z, v, _inv_scale(kind, sigma), kind=kind, bf16=bf16)


def falkon_matvec_masked_reference(x, z, v, mask, sigma: float = 1.0, *,
                                   kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """The plain K7 at the wrapper's signature (any device)."""
    return falkon_matvec_masked_ref(x, z, v, _as_mask(mask, x, v), _inv_scale(kind, sigma),
                                    kind=kind, bf16=bf16)


def knm_t_reference(x, z, y, sigma: float = 1.0, *, kind: str = "gaussian",
                    bf16: bool = False) -> torch.Tensor:
    """The plain K3 at the wrapper's signature (any device)."""
    return knm_t_ref(x, z, y, _inv_scale(kind, sigma), kind=kind, bf16=bf16)


def knm_matvec_reference(x, z, alpha, sigma: float = 1.0, *, kind: str = "gaussian",
                         bf16: bool = False) -> torch.Tensor:
    """The plain K4 at the wrapper's signature (any device)."""
    return knm_matvec_ref(x, z, alpha, _inv_scale(kind, sigma), kind=kind, bf16=bf16)
