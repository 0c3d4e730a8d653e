"""Public wrapper of K8, causal or bidirectional GQA flash attention (forward).

Takes the reference's layout, q (B, Hq, S, D) and k/v (B, Hkv, S, D) with
Hq % Hkv == 0, fp32 or bf16 (one dtype for all three), and returns (B, Hq, S,
D) in q's dtype; the scale is 1/sqrt(D). Any S and any D up to 128: nothing
is padded, the kernel masks the ragged edges itself. A CUDA tensor goes to
a kernel of ``flash_attention.cu`` (through the extension ``build.py``
loads) or the call raises: bf16 to the tensor-core kernel (``mma.sync``,
fp32 accumulation and softmax, P rounded to bf16 before P V), fp32 to the
IEEE fp32 kernel on the FMA units. A CPU tensor goes to the plain version in
``ref.py``. ``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import math

import torch

from .. import build
from ..common import is_cpu, require_cuda
from .ref import CHUNK, attention_ref

#: the largest head dim the kernel takes.
MAX_D = 128
DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:] or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"need q (B, Hq, S, D) and k, v (B, Hkv, S, D) with Hq % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    softcap: float = 0.0, chunk: int = CHUNK) -> torch.Tensor:
    """softmax(q k^T / sqrt(D), causal if asked) v, the kv head of q head h
    being h // (Hq / Hkv). ``softcap > 0`` runs only on the CPU (K8 has
    none). ``chunk`` is the plain version's query rows per step (it bounds
    memory, not the result); the kernel streams kv tiles and ignores it."""
    _check(q, k, v)
    if is_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, softcap=softcap, chunk=chunk)
    if softcap > 0.0:
        raise NotImplementedError("K8 has no logit softcap; no configuration sets one")
    if q.shape[3] > MAX_D:
        raise ValueError(f"K8 takes a head dim of at most {MAX_D}, got {q.shape[3]}")
    q = require_cuda(q, "q", DTYPES)
    k = require_cuda(k, "k", DTYPES)
    v = require_cuda(v, "v", DTYPES)
    if not k.dtype == v.dtype == q.dtype:
        raise ValueError(f"q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build.extension().flash_attention(q, k, v, out, causal, 1.0 / math.sqrt(q.shape[3]))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, softcap: float = 0.0) -> torch.Tensor:
    """The plain K8 at the wrapper's signature (any device)."""
    _check(q, k, v)
    return attention_ref(q, k, v, causal=causal, softcap=softcap)
