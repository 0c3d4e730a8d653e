"""Shared neural layers: the initializer, norms, rotary embeddings, MLPs.

The port of the reference's ``repro.models.layers``. Parameters keep the
reference's (in, out) layout, so a layer computes ``x @ w`` and weights carry
across unchanged (``repro_torch.interop``). ``rms_norm`` and ``lowp`` are
``torch.autograd.Function``s with the reference's custom VJPs: rms_norm's dx
comes back in x's dtype and its dgamma is the sum over all rows in gamma's;
``lowp`` is the identity whose cotangent is cast to the forward dtype. As
the K8 and K9 wrappers, each enters its Function only when a gradient is
taken (grad mode on and an input that requires one); serving and decode
call the plain forward.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.common import needs_grad
from ..sharding import collectives as tp


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


#: while ``models.model.init_blocks`` builds a model: the function each new
#: parameter passes through before its module keeps it (the last one set)
_ON_PARAM: list = []


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter that asks for no gradient: the model serves as built, and
    training differentiates the ``TrainState``'s tensors put in its place
    (``repro_torch.training``)."""
    p = nn.Parameter(t, requires_grad=False)
    return _ON_PARAM[-1](p) if _ON_PARAM else p


# --- norms -----------------------------------------------------------------


def _rms_fwd(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + gamma.float())).to(x.dtype), inv


class _RmsNorm(torch.autograd.Function):
    """The reference's ``_rms_fwd`` / ``_rms_bwd``."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, inv = _rms_fwd(x, gamma, eps)
        ctx.save_for_backward(x, gamma, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, inv = ctx.saved_tensors
        xhat = x.float() * inv
        dxhat = dy.float() * (1.0 + gamma.float())
        # d/dx of x * rsqrt(mean(x^2) + eps)
        dx = inv * (dxhat - xhat * torch.mean(dxhat * xhat, dim=-1, keepdim=True))
        dgamma = torch.sum(dy.float() * xhat, dim=tuple(range(x.ndim - 1)))
        return dx.to(x.dtype), dgamma.to(gamma.dtype), None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a (1 + gamma) gain, fp32 inside, x's dtype out; its
    gradient dx is cast back to x's dtype (the reference's low-precision
    gradient boundary)."""
    if needs_grad(x, gamma):
        return _RmsNorm.apply(x, gamma, eps)
    return _rms_fwd(x, gamma, eps)[0]


class _Lowp(torch.autograd.Function):
    """The reference's ``_lowp_fwd`` / ``_lowp_bwd``."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.dtype)


def lowp(x: torch.Tensor) -> torch.Tensor:
    """Identity whose gradient is cast to x's dtype (the reference's
    low-precision gradient boundary on the q/k/v projections)."""
    return _Lowp.apply(x) if needs_grad(x) else x


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
        """Under a mesh ``w_gate`` / ``w_up`` are column-parallel and
        ``w_down`` row-parallel over ``model`` (each rank's ff block; a
        zero-padded block adds zeros), each gathered over ``data``."""
        x = tp.copy_to_model(x)
        w_up, w_down = tp.weight(self, "w_up"), tp.weight(self, "w_down")
        if self.w_gate is not None:
            h = act_fn(self.act, x @ tp.weight(self, "w_gate")) * (x @ w_up)
        else:
            h = act_fn(self.act, x @ w_up)
        return tp.reduce_from_model(h @ w_down)
