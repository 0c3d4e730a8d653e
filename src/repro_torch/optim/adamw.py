"""AdamW with fp32 master weights over the model's compute params.

The port of ``repro.optim.adamw``, with the reference's formula (not
``torch.optim.AdamW``, which decays before the moment step): per parameter
the clipped gradient g * min(1, clip / max(|g|, 1e-9)) updates mu and nu,
and the master moves by lr (mu_hat / (sqrt(nu_hat) + eps) + wd * master).
The state is a dict {"step", "master", "mu", "nu"} of fp32 tensors keyed
as the params are.

One departure: JAX's arrays are immutable and its update returns a new
state; ``adamw_update`` writes the master, the moments and the params in
place and returns them. At gemma-2b's 2.5 B parameters the fp32 state is
30 GB, and a second copy beside the first would not fit the card.
``adamw_init`` copies (an fp32 param never aliases its master).
``opt_state_specs`` mirrors the param specs over that layout.
"""
from __future__ import annotations

import dataclasses

import torch

from ..sharding.rules import PartitionSpec


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr(self, step) -> torch.Tensor:
        from .schedules import make_schedule

        return make_schedule(self.schedule, peak_lr=self.peak_lr, warmup=self.warmup,
                             total=self.total_steps)(step)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Step 0, an fp32 copy of every param as its master, zero moments."""
    with torch.no_grad():
        return {
            "step": torch.zeros((), dtype=torch.int64),
            "master": {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()},
            "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }


def opt_state_specs(pspecs: dict) -> dict:
    """Opt-state PartitionSpecs mirroring the param specs (``adamw_init``'s
    layout: the step replicated, master, mu and nu as their params)."""
    return {"step": PartitionSpec(), "master": pspecs, "mu": pspecs, "nu": pspecs}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their fp32 squared sums (0-d fp32)."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], state: dict,
                 cfg: OptConfig, *, grad_norm: torch.Tensor | None = None
                 ) -> tuple[dict[str, torch.Tensor], dict]:
    """One AdamW step from ``grads`` (any float dtype; keyed as ``params``).
    Updates ``state``'s master, mu and nu and ``params`` in place (params
    get the master cast to their dtype) and returns (params, state) with
    the step advanced. ``grad_norm`` is ``global_norm(grads)`` when the
    caller has it already (one pass over the gradients fewer)."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    dev = next(iter(state["master"].values())).device
    lr = cfg.lr(step).to(dev)
    if grad_norm is None:
        grad_norm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(grad_norm, min=1e-9), max=1.0)
    c1 = (1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf).to(dev)
    c2 = (1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf).to(dev)
    for k, p in params.items():
        m, mu, nu = state["master"][k], state["mu"][k], state["nu"][k]
        g = grads[k].float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        m.sub_(lr * (mu / c1 / (torch.sqrt(nu / c2) + cfg.eps) + cfg.weight_decay * m))
        p.copy_(m)
    state["step"] = step
    return params, state
