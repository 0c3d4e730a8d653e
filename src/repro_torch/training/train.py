"""Training step: gradients (with optional microbatch accumulation) + AdamW.

The port of ``repro.training.train`` on one card. A ``TrainState`` holds the
params (the LM's tensors, by ``state_dict`` name) and the AdamW state.
``make_train_step`` returns ``train_step(state, batch) -> (state, metrics)``:
the forward and backward run through ``torch.func.functional_call`` on the
state's params (so any state, a restored one too, steps the same module),
with K8 and K9 in the forward on the card and their plain versions' gradient
in the backward (``kernels/flash_attention``, ``kernels/ssd``); per-layer
recomputation under ``cfg.remat``; the chunked cross-entropy of
``models.loss_fn``. With ``microbatches`` > 1 the batch is split on its
leading axis and the gradients are summed in fp32, then averaged, as the
reference's ``lax.scan`` does. Metrics: ``loss``, ``lr`` and ``grad_norm``
(0-d tensors; the norm is of the averaged gradient, before clipping).

The step updates the state's tensors in place (``optim.adamw``) and
returns it. ``grad_shardings`` pins the reference's fp32 accumulator to a
mesh sharding; on one card it has no meaning (and under a mesh the port's
gradients keep the params' layout), so only ``None`` is taken.

Under a ``DeviceMesh`` of more than one rank (``sharding.activate_mesh``)
the same step runs sharded: the state holds each rank's blocks
(``sharding.distribute_state``), the batch the rank's rows; the backward's
reduce-scatters sum the split leaves' gradients over ``data``,
``collectives.finish_grads`` sums the replicated ones, the norm counts each
element once across ranks, and AdamW updates each rank's blocks with the
global norm's clip. The loss is the global one on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from ..checkpoint.ckpt import _leaves
from ..models import LM, loss_fn
from ..models.config import ArchConfig
from ..optim import OptConfig, adamw_init, adamw_update
from ..sharding import collectives as tp


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: dict


def train_state_init(cfg_or_lm: ArchConfig | LM, *, seed: int = 0,
                     device: str = "cuda") -> TrainState:
    """The state of a fresh model: ``LM(cfg, seed=seed, device=device)``'s
    params (an ``LM`` given instead lends its own tensors: no copy) and
    ``adamw_init`` of them. The params are set to require a gradient."""
    lm = cfg_or_lm if isinstance(cfg_or_lm, LM) else LM(cfg_or_lm, seed=seed, device=device)
    params = {k: p.detach().requires_grad_(True) for k, p in lm.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params))


def copy_state_(dst: Any, src: Any) -> Any:
    """Copy every leaf of ``src`` into the matching leaf of ``dst`` in place
    (same structure; a restored checkpoint's CPU tensors into a state on
    the card, without a second copy of it there). Returns ``dst``."""
    with torch.no_grad():
        for (_, d), (_, s) in zip(_leaves(dst), _leaves(src), strict=True):
            d.copy_(s)
    return dst


class _Objective(nn.Module):
    """loss_fn and its gradient in one call, so that ``functional_call``
    holds the state's params in the module through the backward too (the
    per-layer recomputation reads them there)."""

    def __init__(self, lm: LM, n_chunks: int):
        super().__init__()
        self.lm = lm
        self.n_chunks = n_chunks

    def forward(self, batch: dict, wrt: list[torch.Tensor]):
        loss = loss_fn(self.lm, batch, n_chunks=self.n_chunks)
        return loss.detach(), torch.autograd.grad(loss, wrt)


def loss_and_grads(lm: LM, params: dict[str, torch.Tensor], batch: dict, *,
                   loss_chunks: int = 8) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(``loss_fn`` of ``lm``'s model at ``params``, its gradient by name):
    the reference's ``jax.value_and_grad(loss_fn)``. The params are set to
    require a gradient (a restored state's tensors come without the flag).
    Under a mesh: the global loss, and each rank's blocks of the full
    gradient."""
    for p in params.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, grads = torch.func.functional_call(
            _Objective(lm, loss_chunks), {f"lm.{k}": p for k, p in params.items()},
            (batch, list(params.values())))
    grads = tp.finish_grads(dict(zip(params, grads)), lm.logical)
    return tp.sum_over_batch(loss), grads


def make_train_step(cfg_or_lm: ArchConfig | LM, opt_cfg: OptConfig, *, microbatches: int = 1,
                    loss_chunks: int = 8,
                    grad_shardings: Any = None) -> Callable[[TrainState, dict],
                                                            tuple[TrainState, dict]]:
    """``train_step(state, batch)`` for the model of ``cfg_or_lm`` (an
    ``ArchConfig`` gets a weightless ``LM`` on the meta device to run the
    state's params through; an ``LM`` is used as it is, its own weights
    unread). ``batch`` holds the forward's inputs and "labels" (B, S), on
    the state's device, B a multiple of ``microbatches``."""
    if grad_shardings is not None:
        raise ValueError("grad_shardings pins a mesh sharding; on one card pass None")
    if microbatches < 1:
        raise ValueError(f"microbatches must be positive, got {microbatches}")
    lm = cfg_or_lm if isinstance(cfg_or_lm, LM) else LM(cfg_or_lm, device="meta")

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if microbatches == 1:
            loss, grads = loss_and_grads(lm, state.params, batch, loss_chunks=loss_chunks)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows does not split into {microbatches}")
            size = rows // microbatches
            loss = torch.zeros((), dtype=torch.float32)
            grads = None
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l, g = loss_and_grads(lm, state.params, mb, loss_chunks=loss_chunks)
                loss = loss.to(l.device) + l.float()
                if grads is None:
                    grads = {k: t.float() for k, t in g.items()}
                else:
                    for k, t in g.items():
                        grads[k] += t.float()
                del g
            loss = loss / microbatches
            for t in grads.values():
                t.div_(microbatches)
        gnorm = tp.global_norm(grads, lm.logical)
        params, opt = adamw_update(state.params, grads, state.opt, opt_cfg, grad_norm=gnorm)
        metrics = {"loss": loss, "lr": opt_cfg.lr(opt["step"]), "grad_norm": gnorm}
        return TrainState(params, opt), metrics

    return train_step
