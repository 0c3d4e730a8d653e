"""Public wrapper of K8, causal or bidirectional GQA flash attention (forward).

Takes the reference's layout, q (B, Hq, S, D) and k/v (B, Hkv, S, D) with
Hq % Hkv == 0, fp32 or bf16 (one dtype for all three), and returns (B, Hq, S,
D) in q's dtype; the scale is 1/sqrt(D). Any S and any D from 1 to 256 (the
reference's wrapper pads D to 128 lanes and takes any D; gemma-2b's heads
are 256 wide): nothing is padded in device memory, the kernel masks the
ragged edges itself, and above D = 128 it runs its 192- and 256-wide tiles
(the tensor-core kernel then reloads its q fragments from shared memory at
every k-step instead of holding them in registers). A D above 256 raises. A
CUDA tensor goes to a kernel of ``flash_attention.cu`` (through the
extension ``build.py`` loads) or the call raises: bf16 to the tensor-core
kernel (``mma.sync``, fp32 accumulation and softmax, P rounded to bf16
before P V), fp32 to the IEEE fp32 kernel on the FMA units. A CPU tensor
goes to the plain version in ``ref.py``. ``flash_attention.launches`` counts
the kernel launches.

Gradients. The reference has no backward kernel: it trains through its jnp
``attention()``, whose gradient XLA derives. On the card the wrapper is a
``torch.autograd.Function``: its forward is always the kernel's output, and
its backward recomputes the plain version under autograd on the saved
inputs and returns that function's gradient (``flash_attention.backward_recomputes``
counts these; ``ref.attention_ref.cuda_calls`` counts every plain call on a
CUDA tensor, so a run can show that each came from a backward). A backward
kernel is later work (ROADMAP B).
"""
from __future__ import annotations

import math

import torch

from .. import build
from ..common import is_cpu, needs_grad, require_cuda
from .ref import CHUNK, attention_ref

#: the largest head dim the kernel takes.
MAX_D = 256
DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:] or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"need q (B, Hq, S, D) and k, v (B, Hkv, S, D) with Hq % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """One K8 launch on checked CUDA tensors (counted)."""
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


class _FlashAttention(torch.autograd.Function):
    """K8 forward; the plain version's gradient, recomputed, backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        flash_attention.backward_recomputes += 1
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = attention_ref(*leaves, causal=ctx.causal)
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(got) if t.requires_grad else None for t in leaves), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    softcap: float = 0.0, chunk: int = CHUNK) -> torch.Tensor:
    """softmax(q k^T / sqrt(D), causal if asked) v, the kv head of q head h
    being h // (Hq / Hkv). ``softcap > 0`` runs only on the CPU (K8 has
    none). ``chunk`` is the plain version's query rows per step (it bounds
    memory, not the result); the kernel streams kv tiles and ignores it.
    Differentiable on both devices (see the module docstring)."""
    _check(q, k, v)
    if is_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, softcap=softcap, chunk=chunk)
    if softcap > 0.0:
        raise NotImplementedError("K8 has no logit softcap; no configuration sets one")
    if q.shape[3] > MAX_D:
        raise ValueError(f"K8 takes a head dim of at most {MAX_D}, got {q.shape[3]}")
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return _launch(q, k, v, causal)


flash_attention.launches = 0
flash_attention.backward_recomputes = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, softcap: float = 0.0) -> torch.Tensor:
    """The plain K8 at the wrapper's signature (any device)."""
    _check(q, k, v)
    return attention_ref(q, k, v, causal=causal, softcap=softcap)
