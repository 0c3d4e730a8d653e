"""Attention: exact attention for the full-sequence forward, decode with a
KV cache, and BLESS-Nystrom attention (the paper's technique inside the LM).

The port of the reference's ``repro.models.attention``. ``attention`` keeps
its (B, S, H, D) layout and runs K8 (``kernels/flash_attention``) on a CUDA
tensor and K8's plain version, the reference's chunked attention, on a CPU
tensor. (The reference's docstring calls its Pallas flash kernel the drop-in
for the chunked path through a ``use_pallas`` flag in ``model.py``; that flag
does not exist there, and only its tests call the kernel. Here K8 is what
``attention`` runs on the card.) ``decode_attention`` is plain PyTorch on
either device: the reference has no kernel for it. Its partial form,
``decode_attention_partial``, gives one block of the cache's sequence the
statistics that merge across blocks (decode under a mesh).

BLESS-Nystrom attention (DESIGN.md section 3): softmax attention through M
landmark keys chosen by their ridge leverage scores in the key Gram matrix
(Gaussian kernel, 1 / (2 sqrt(D)) in the exponent), one rung of the BLESS
ladder against a strided pilot set, the top M by score in place of
sampling. ``rls_scores_one_rung``, ``bless_topm_landmarks``,
``nystrom_attention``, ``_iterative_pinv`` and ``bless_compress_cache``
are the reference's functions, batched over any leading axes (every
(batch, kv head) at once: batched Cholesky, triangular solve, sort and
gather) where the reference vmaps. None of them is a Pallas kernel in the
reference, so they are plain PyTorch on both devices; under a serving
mesh ``bless_compress_cache`` takes and gives the rank's blocks of a cache
split over the sequence (the reference's runs on a global array, whatever
its sharding). The top M is taken
by a stable descending sort, so tied scores (at the [1e-12, 1] clip) go to
the lower index first, as ``jax.lax.top_k`` orders them.

``nystrom_attention`` has no causal mask, in the reference too, which calls
it for causal decoders as well: a prompt position sees later tokens there
(ROADMAP C.2e). The port keeps that for parity.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import NEG
from ..sharding import collectives


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              chunk: int = 512, softcap: float = 0.0) -> torch.Tensor:
    """Exact attention. q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D).

    On the CPU the query rows go ``chunk`` at a time, as the reference's do;
    on the card K8 streams the kv tiles and ``chunk`` does not matter. A
    ``softcap > 0`` on a CUDA tensor raises ``NotImplementedError`` (K8 has
    no softcap; no configuration sets one)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # (B, H, S, D)
    out = flash_ops.flash_attention(qt, kt, vt, causal=causal, softcap=softcap, chunk=chunk)
    return out.transpose(1, 2)


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor, softcap: float,
                   length: torch.Tensor | None, offset: int = 0) -> torch.Tensor:
    """fp32 scores (B, Hkv, G, S) of one query token against the cache rows,
    those at a position (``offset`` + row) past ``length`` at -1e30."""
    b, s, hkv, d = k_cache.shape
    qg = q[:, 0].reshape(b, hkv, q.shape[2] // hkv, d)  # (B, Hkv, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * (1.0 / math.sqrt(d))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if length is not None:
        lens = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
        valid = torch.arange(offset, offset + s, device=q.device)[None, None, None, :] < lens
        scores = torch.where(valid, scores, scores.new_full((), NEG))
    return scores


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     softcap: float = 0.0, length: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token decode. q (B, 1, Hq, D); caches (B, S, Hkv, D); ``length``
    a scalar or per-slot (B,) count of valid cache rows (the rest are masked
    with -1e30)."""
    b, _, hkv, d = k_cache.shape
    p = torch.softmax(_decode_scores(q, k_cache, softcap, length), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, q.shape[2], d).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                             softcap: float = 0.0, length: torch.Tensor | None = None,
                             offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_attention`` over one block of the cache's sequence, whose
    rows sit at positions ``offset`` on, as the statistics that merge
    across blocks (``sharding.collectives.merge_attention``): the
    unnormalised sum acc (B, Hq, D) = sum_j e^(s_j - m) v_j, the max m and
    the sum of exponentials l, each (B, Hq), all fp32."""
    b, _, hkv, d = k_cache.shape
    hq = q.shape[2]
    scores = _decode_scores(q, k_cache, softcap, length, offset)
    mx = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    acc = torch.einsum("bkgs,bskd->bkgd", e, v_cache.float())
    return acc.reshape(b, hq, d), mx.reshape(b, hq), torch.sum(e, dim=-1).reshape(b, hq)


# ---------------------------------------------------------------------------
# BLESS-Nystrom: leverage-score landmarks
# ---------------------------------------------------------------------------


def rls_scores_one_rung(keys: torch.Tensor, m_pilot: int, lam: float) -> torch.Tensor:
    """One BLESS rung: Eq. 3 scores of every key against a strided pilot set.

    keys (..., S, D) -> scores (..., S) fp32. Gaussian kernel
    exp(-|a - b|^2 / (2 sqrt(D))); pilot ``keys[::max(1, S // m_pilot)][:m_pilot]``;
    regulariser lam * m_pilot + 1e-5 on the pilot Gram's diagonal; K_ii = 1;
    scores (1 - k_i^T K_JJ^-1 k_i) / (lam S) clipped to [1e-12, 1].
    """
    s, d = keys.shape[-2:]
    kf = keys.float()
    inv = 1.0 / (2.0 * math.sqrt(d))
    stride = max(1, s // m_pilot)
    pilot = kf[..., ::stride, :][..., :m_pilot, :]
    mp = pilot.shape[-2]

    def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d2 = (torch.sum(a * a, -1)[..., :, None] + torch.sum(b * b, -1)[..., None, :]
              - (2 * a) @ b.transpose(-1, -2))
        return torch.exp(-torch.clamp_min(d2, 0.0) * inv)

    eye = torch.eye(mp, dtype=torch.float32, device=keys.device)
    kjj = gram(pilot, pilot) + (lam * s * (mp / s) + 1e-5) * eye
    g = gram(kf, pilot)  # (..., S, mp)
    chol = torch.linalg.cholesky(kjj)
    vsol = torch.linalg.solve_triangular(chol, g.transpose(-1, -2), upper=False)
    quad = torch.sum(vsol * vsol, dim=-2)
    return torch.clamp((1.0 - quad) / (lam * s), 1e-12, 1.0)


def _top_indices(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` largest scores along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :m]


def bless_topm_landmarks(keys: torch.Tensor, m: int, *, m_pilot: int = 128,
                         lam: float = 1e-3) -> torch.Tensor:
    """Indices (..., m) of the top-m leverage-score keys. keys (..., S, D)."""
    return _top_indices(rls_scores_one_rung(keys, m_pilot, lam), m)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., S, D) at rows idx (..., m) -> (..., m, D)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def nystrom_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, landmarks: int,
                      lam: float = 1e-3) -> torch.Tensor:
    """Sub-quadratic bidirectional attention through RLS landmarks.

    q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype; cost
    O(S M) with M = min(landmarks, S):
      out = softmax(Q K_L^T) pinv(softmax(Q_L K_L^T)) softmax(Q_L K^T) V,
    the landmarks L being each (batch, kv head)'s top-M leverage-score keys
    (its q heads share them). fp32 inside. No causal mask (ROADMAP C.2e).
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    m = min(landmarks, s)
    qf = q.float().reshape(b, s, hkv, group, d).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, S, D)
    kf = k.float().permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    vf = v.float().permute(0, 2, 1, 3)
    idx = bless_topm_landmarks(kf, m, lam=lam)  # (B, Hkv, M)
    kl = _rows(kf, idx)  # (B, Hkv, M, D)
    ql = _rows(qf, idx[:, :, None].expand(b, hkv, group, m))  # (B, Hkv, G, M, D)
    f1 = torch.softmax(torch.einsum("bhgsd,bhmd->bhgsm", qf, kl) * scale, dim=-1)
    a = torch.softmax(torch.einsum("bhgmd,bhnd->bhgmn", ql, kl) * scale, dim=-1)
    f2 = torch.softmax(torch.einsum("bhgmd,bhsd->bhgms", ql, kf) * scale, dim=-1)
    a_pinv = _iterative_pinv(a)
    out = torch.einsum("bhgsm,bhgmn->bhgsn", f1, a_pinv) @ (f2 @ vf[:, :, None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def _iterative_pinv(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton-Schulz pseudo-inverse (Nystromformer Eq. 16) of each (n, n)
    matrix of a (..., n, n), started from a^T over (largest row sum x
    largest column sum) of |a|."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    norm = (torch.amax(torch.sum(torch.abs(a), -1), -1, keepdim=True)[..., None]
            * torch.amax(torch.sum(torch.abs(a), -2), -1, keepdim=True)[..., None])
    z = a.transpose(-1, -2) / norm
    for _ in range(iters):
        az = a @ z
        z = 0.25 * z @ (13.0 * eye - az @ (15.0 * eye - az @ (7.0 * eye - az)))
    return z


def bless_compress_cache(k_cache: torch.Tensor, v_cache: torch.Tensor, m: int, *,
                         m_pilot: int = 256, lam: float = 1e-4) -> tuple[torch.Tensor, torch.Tensor]:
    """Leverage-score KV-cache compression: the top-m RLS keys of each
    (batch, kv head) and their values. caches (B, S, Hkv, D) -> (B, m, Hkv, D),
    in the caches' dtype, in score order.

    Under a serving mesh (``sharding.serve_ctx``) the caches are the rank's
    ``cache_specs`` blocks, the sequence split over ``model`` or ``data`` x
    ``model``, and so is the result, at length ``m``: the sequence is
    gathered over its ranks in one collective, every rank compresses the
    whole of its rows' caches (the unsharded call's work on the same
    values) and keeps its block of the m rows. ``m`` must divide over the
    sequence's ranks."""
    plan = collectives.active()
    ways = plan.kv_ways if plan is not None else 1
    if m % ways:
        raise ValueError(f"m = {m} compressed rows do not split over the cache sequence's "
                         f"{ways} ranks")
    if ways > 1:
        d = k_cache.shape[-1]
        both = collectives.gather_kv_seq(torch.cat([k_cache, v_cache], dim=-1))
        k_cache, v_cache = both[..., :d].contiguous(), both[..., d:].contiguous()
    kt = k_cache.permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    vt = v_cache.permute(0, 2, 1, 3)
    idx = bless_topm_landmarks(kt, m, m_pilot=m_pilot, lam=lam)  # (B, Hkv, m)
    kc, vc = _rows(kt, idx).permute(0, 2, 1, 3), _rows(vt, idx).permute(0, 2, 1, 3)
    if ways > 1:
        lo, per = plan.kv_index * (m // ways), m // ways
        kc, vc = kc[:, lo:lo + per], vc[:, lo:lo + per]
    return kc, vc
