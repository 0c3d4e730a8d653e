"""GPipe-style pipeline parallelism over a ``torch.distributed`` group.

The port of ``repro.training.pipeline``. The layers are split into S
stages, one per rank of the group (rank s holds stage s's params);
microbatches stream through the reference's GPipe schedule: S + M - 1
steps, at step t stage s computes microbatch t - s, stage 0 injects
microbatch min(t, M - 1), the last stage writes output slot t - (S - 1),
and every rank runs every step in lockstep, bubble included, as the
reference's SPMD ``scan`` does.

Differentiation works through the schedule as in the reference: the shift
to the next stage (``_ShiftRight``) is an ``autograd.Function`` whose
forward sends to rank s + 1 and receives from s - 1 on a ring and whose
backward is the reverse ring ("the transpose of ppermute is the reverse
permute"), so the gradient of the pipelined forward *is* the GPipe
backward. Every shift's output stays in the graph on every rank (stage 0
selects its injection with ``torch.where``; the final carry enters the
output's broadcast), so every rank runs every shift's backward, in step
order: no rank waits on a peer that skipped one.

The outputs exist on the last stage only; they reach every rank by a sum
over the group of the last stage's buffer and zeros elsewhere, the
reference's ``psum``. Its backward hands each rank's cotangent straight to
its buffer: the loss every rank computes from the replicated output is one
loss, as in the reference, where ``torch.distributed.nn.functional.all_reduce``
would sum the S ranks' equal cotangents into S times the gradient.

Transport. A gloo group takes host tensors only, so CUDA activations are
staged through host memory for its sends, receives and sum (a transport
choice, as ``core.distributed`` stages its partials; each stage's compute
stays on the card). NCCL refuses two ranks on one device: ranks that share
the card use gloo.

Without a group (or in a group of one rank) it is a world of one:
``n_stages`` must be 1, and the microbatches run through the one stage in
order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _world(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _staged(group, t: Tensor) -> bool:
    """True when ``t`` must go through host memory for ``group``'s backend."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _ring(x: Tensor, group, step: int) -> Tensor:
    """Send ``x`` ``step`` ranks on around the ring (+1 forward, -1 back)
    and return what the rank ``step`` behind sent."""
    rank, size = _world(group)
    wire = x.detach().to("cpu") if _staged(group, x) else x.detach()
    wire = wire.contiguous()
    got = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, dist.get_global_rank(group, (rank + step) % size),
                      group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group, (rank - step) % size),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(x.device)


class _ShiftRight(torch.autograd.Function):
    """Stage s's activation to stage s + 1 (ring); backward, the reverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, +1)

    @staticmethod
    def backward(ctx, grad):
        return _ring(grad, ctx.group, -1), None


class _Broadcast(torch.autograd.Function):
    """The last stage's output buffer to every rank (a sum over the group of
    it and the others' zeros). ``carry``, the final shift's output, which no
    stage reads, gets a zero gradient, so that its shift's backward runs on
    every rank."""

    @staticmethod
    def forward(ctx, buf, carry, group):
        ctx.carry = (carry.shape, carry.dtype, carry.device)
        wire = buf.detach().to("cpu") if _staged(group, buf) else buf.detach().clone()
        dist.all_reduce(wire, group=group)
        return wire.to(buf.device)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.carry
        return grad, torch.zeros(shape, dtype=dtype, device=device), None


def pipeline_apply(stage_fn: Callable[[Any, Tensor], Tensor], n_stages: int,
                   n_microbatches: int, group=None, *,
                   axis: str = "pipe") -> Callable[[Any, Tensor], Tensor]:
    """Build a pipelined forward.

    stage_fn(stage_params, x_mb) -> x_mb : one stage's computation on one
      microbatch (its slice of the layer stack, run in order).
    group: the ``pipe`` group, one rank per stage (rank s runs stage s);
      None for a world of one. ``axis`` names the mesh axis it came from
      (``DeviceMesh.get_group(axis)``), as the reference's argument does.
    Returns ``run(stage_params, x)``: ``stage_params`` this rank's stage's,
    x (n_microbatches, mb, ...) the same on every rank; gives the
    (n_microbatches, mb, ...) outputs of the last stage on every rank.
    """
    rank, size = _world(group)
    if size != n_stages:
        raise ValueError(f"{n_stages} stages on a {axis!r} group of {size} ranks")
    steps = n_stages + n_microbatches - 1

    def run(params: Any, x: Tensor) -> Tensor:
        if x.shape[0] != n_microbatches:
            raise ValueError(f"x has {x.shape[0]} microbatches, not {n_microbatches}")
        if size == 1:
            return torch.stack([stage_fn(params, x[i]) for i in range(n_microbatches)])
        first = torch.tensor(rank == 0, device=x.device)
        state = x.new_zeros(x.shape[1:])
        slots = []
        for t in range(steps):
            # stage 0 injects microbatch t; everyone else takes the
            # neighbour's activation from the previous step
            state = torch.where(first, x[min(t, n_microbatches - 1)], state)
            state = stage_fn(params, state)
            # the last stage's finished microbatch lands in the output buffer
            if rank == n_stages - 1 and t >= n_stages - 1:
                slots.append(state)
            # hand activations to the next stage
            state = _ShiftRight.apply(state, group)
        buf = torch.stack(slots) if slots else x.new_zeros(x.shape)
        return _Broadcast.apply(buf, state, group)

    return run


def stack_stages(params_layers: Any, n_stages: int) -> Any:
    """Reshape the leading layer dim L -> (n_stages, L / n_stages) on every
    tensor of ``params_layers`` (a tensor, or dicts, lists and tuples of
    them)."""
    if isinstance(params_layers, dict):
        return {k: stack_stages(v, n_stages) for k, v in params_layers.items()}
    if isinstance(params_layers, (list, tuple)):
        return type(params_layers)(stack_stages(v, n_stages) for v in params_layers)
    l = params_layers.shape[0]
    if l % n_stages:
        raise ValueError(f"{l} layers do not split into {n_stages} stages")
    return params_layers.reshape((n_stages, l // n_stages) + tuple(params_layers.shape[1:]))
