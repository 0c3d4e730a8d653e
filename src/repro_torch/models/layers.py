"""Shared neural layers: the initializer, norms, rotary embeddings, MLPs.

The port of the reference's ``repro.models.layers``. Parameters keep the
reference's (in, out) layout, so a layer computes ``x @ w`` and weights carry
across unchanged (``repro_torch.interop``). ``rms_norm`` is the forward only
(the reference's custom VJP is a training concern, and so is ``lowp``'s
gradient boundary: ``lowp`` is the identity here).
"""
from __future__ import annotations

import math

import torch
from torch import nn


# --- init ------------------------------------------------------------------


def ninit(shape, *, generator: torch.Generator, scale: float | None = None,
          dtype: torch.dtype = torch.bfloat16, device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times ``scale``
    (1 / sqrt(fan_in) by default), drawn in fp32 and cast to ``dtype``.

    The fan-in is ``shape[0]`` for any tensor of two or more dims, as the
    reference's rule has it: for the stacked expert weights (E, d, ff) that is
    the expert count E, so they start 16x wider than a dense weight at
    Jamba's width (a fault shared with the reference, ROADMAP C).
    """
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    return (w * scale).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter without gradient (the port serves; training is a later slice)."""
    return nn.Parameter(t, requires_grad=False)


# --- norms -----------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a (1 + gamma) gain, fp32 inside, x's dtype out."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + gamma.float())).to(x.dtype)


def lowp(x: torch.Tensor) -> torch.Tensor:
    """Identity (the reference's low-precision gradient boundary)."""
    return x


# --- rotary ----------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                           / head_dim)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) -> rotated x (half-split layout)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)  # angles (..., S, D/2)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions_3d (B, 3, S); the D/2 frequency
    slots are split into (t, h, w) sections, each rotated by its own position
    stream. Equal streams reduce exactly to ``apply_rope``."""
    d = x.shape[-1]
    half = d // 2
    tot = sum(sections)
    sec = [s * half // tot for s in sections]  # static rescale to head_dim/2
    sec[-1] += half - sum(sec)
    bounds = torch.tensor([sec[0], sec[0] + sec[1], half], device=x.device)
    slot = torch.arange(half, device=x.device)
    which = (slot[None, :] >= bounds[:, None]).sum(0)  # (half,) in {0, 1, 2}
    pos = positions_3d.permute(0, 2, 1).float()[..., which]  # (B, S, half)
    return _rotate(x, pos * rope_freqs(d, theta, device=x.device))


def sinusoidal_pos(seq: int, d_model: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --- mlp -------------------------------------------------------------------


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("swiglu", "silu"):
        return torch.nn.functional.silu(x)
    if name in ("geglu", "gelu"):
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(name)


class MLP(nn.Module):
    """Gated (SwiGLU / GeGLU) or plain (GELU) MLP; x (..., d) -> (..., d)."""

    def __init__(self, d: int, ff: int, act: str, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        self.act = act
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.w_up = param(ninit((d, ff), **kw))
        self.w_down = param(ninit((ff, d), **kw))
        self.w_gate = param(ninit((d, ff), **kw)) if act in ("swiglu", "geglu") else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_gate is not None:
            h = act_fn(self.act, x @ self.w_gate) * (x @ self.w_up)
        else:
            h = act_fn(self.act, x @ self.w_up)
        return h @ self.w_down
