"""Attention: exact attention for the full-sequence forward, and decode with a
KV cache.

The port of the reference's ``repro.models.attention``. ``attention`` keeps
its (B, S, H, D) layout and runs K8 (``kernels/flash_attention``) on a CUDA
tensor and K8's plain version, the reference's chunked attention, on a CPU
tensor. (The reference's docstring calls its Pallas flash kernel the drop-in
for the chunked path through a ``use_pallas`` flag in ``model.py``; that flag
does not exist there, and only its tests call the kernel. Here K8 is what
``attention`` runs on the card.) ``decode_attention`` is plain PyTorch on
either device: the reference has no kernel for it.

BLESS-Nystrom attention (``attention_impl="bless_nystrom"``) and
``bless_compress_cache`` are a later slice of the port.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import NEG


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     softcap: float = 0.0, length: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token decode. q (B, 1, Hq, D); caches (B, S, Hkv, D); ``length``
    a scalar or per-slot (B,) count of valid cache rows (the rest are masked
    with -1e30)."""
    b, s, hkv, d = k_cache.shape
    hq = q.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q[:, 0].reshape(b, hkv, group, d)  # (B, Hkv, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if length is not None:
        lens = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
        valid = torch.arange(s, device=q.device)[None, None, None, :] < lens
        scores = torch.where(valid, scores, scores.new_full((), NEG))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)
