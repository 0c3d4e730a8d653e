"""LR schedules: cosine (default) and WSD (warmup-stable-decay, the MiniCPM
schedule, arXiv:2404.06395). The port of ``repro.optim.schedules``: the
same formulas in fp32, returning a 0-d fp32 tensor on the CPU."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32).cpu()


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor * peak_lr``
    at ``total``."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor: float = 0.05) -> torch.Tensor:
    """Warmup -> flat -> linear decay over the last ``decay_frac`` of ``total``."""
    step = _f32(step)
    decay_start = total * (1.0 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    tail = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
    dec = peak_lr * (1.0 - (1.0 - floor) * tail)
    flat = torch.full_like(step, peak_lr)
    return torch.where(step < warmup, warm, torch.where(step < decay_start, flat, dec))


def make_schedule(name: str, **kw):
    """``step -> lr`` for the schedule ``name`` ("cosine" or "wsd")."""
    fn = {"cosine": cosine_schedule, "wsd": wsd_schedule}[name]
    return lambda step: fn(step, **kw)
