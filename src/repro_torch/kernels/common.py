"""Shared helpers for the hand-written CUDA kernels and their wrappers."""
from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_dim(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to length ``to`` (no-op if already there)."""
    pad = to - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def require_cuda(t: torch.Tensor, name: str,
                 dtypes: tuple[torch.dtype, ...] = (torch.float32,)) -> torch.Tensor:
    """Check that ``t`` can be handed to a kernel: a tensor of one of
    ``dtypes`` (float32 unless the kernel takes more) on a CUDA device.
    Returns it contiguous (a no-op for the callers on the main path)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype not in dtypes:
        allowed = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be {allowed}, got {t.dtype}")
    return t.contiguous()


def needs_grad(*tensors: torch.Tensor) -> bool:
    """A gradient is being taken through one of ``tensors`` (grad mode on and
    one requires it): only then does a wrapper enter its
    ``autograd.Function``; serving calls the forward directly."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (the wrappers then run the plain
    version), or every one on the meta device (the plain version then gives
    shapes alone, and ``launch.cost_model.flop_count`` counts its products);
    False if every one lies on a CUDA device. Mixed devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"meta"}):
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must share one device type, got {sorted(kinds)}")
