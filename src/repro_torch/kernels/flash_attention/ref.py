"""Plain PyTorch version of K8: exact softmax attention with GQA head sharing.

The reference model's chunked attention (``repro.models.attention.attention``)
in the kernel's (B, H, S, D) layout: fp32 math, scores of masked positions set
to -1e30 (not -inf), kv heads broadcast to their q-head groups, and the query
rows taken ``chunk`` at a time so the largest intermediate is (B, Hq, chunk,
S). ``softcap > 0`` applies the reference's ``softcap * tanh(s / softcap)``
to the scores (the CUDA kernel has no softcap; no configuration sets one).
``attention_ref.cuda_calls`` counts its calls on CUDA tensors: K8's backward
and the checks that hold the kernel to it make them, never a forward pass.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30
#: query rows per step of the plain version (the reference's ``attn_chunk``).
CHUNK = 512


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  softcap: float = 0.0, chunk: int = CHUNK) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype."""
    if q.is_cuda:
        attention_ref.cuda_calls += 1
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for q0 in range(0, s, chunk):
        qi = q[:, :, q0:q0 + chunk].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qi, kf) * scale
        if softcap > 0.0:
            scores = softcap * torch.tanh(scores / softcap)
        if causal:
            qpos = q0 + torch.arange(qi.shape[2], device=q.device)
            scores = torch.where(qpos[:, None] >= kpos[None, :], scores,
                                 scores.new_full((), NEG))
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype))
    return torch.cat(outs, dim=2) if outs else q.new_zeros(q.shape)


attention_ref.cuda_calls = 0
