"""Mixture-of-Experts with group-local sort-based dispatch.

The port of the reference's ``repro.models.moe``: every batch row is a
routing group (softmax, top-k, a stable sort by expert, rank within the
expert, capacity drop), tokens are scattered into an (E, C) expert buffer,
the experts run as batched matrix products, and each token sums its top-k
contributions.

Determinism: the ranks come from a stable ``argsort`` and integer counts,
the dispatch writes each kept (token, choice) to its own slot (dropped ones
all go to one discarded row, E C, whose value is never read), and the
combine is a reshape of the (S k, d) contributions to (S, k, d) and a sum
over k in index order: the reference's scatter-add ``.at[src].add`` adds
exactly these, since its ``src`` is ``repeat(arange(S), k)``. No float
atomics (``index_add_``) on the path.

Under a mesh the layout is the reference's ``cfg.moe_mode(16)``: ``ep``
(experts over ``model``), ``tp`` (each expert's ff columns over
``model``) or ``replicate``. The residual is replicated over ``model``, so
every ``model`` rank already holds every token of its rows and the
reference's all-to-all has nothing to move: the split MoE is a
row-parallel product. The input and the router enter through
``copy_to_model`` (their gradients are each rank's experts' parts), every
rank routes identically (the capacity drop before the split: a token
dropped on one rank is dropped on all), runs its experts (``ep``) or its
ff columns of every expert (``tp``) on its part of the dispatch buffer,
and one ``reduce_from_model`` sums the partial combines in rank order.
``replicate`` on ``model`` > 1 runs the whole MoE on every rank and sums
nothing over ``model``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..sharding import collectives as tp
from .layers import MLP, act_fn, ninit, param


def capacity(s: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots per expert for a group of ``s`` tokens (at least 8)."""
    return max(8, int(s * top_k * capacity_factor / n_experts))


def route_group(x: torch.Tensor, router: torch.Tensor, top_k: int, cap: int,
                n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Routing of every group at once. x (G, S, d) -> (slot, gate), each
    (G, S k): the flat expert-buffer slot in [0, E C] (E C = dropped) and the
    renormalised top-k router probability of each (token, choice) in token
    order."""
    g, s, _ = x.shape
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # (G, S, E)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)  # (G, S, k), descending
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(g, s * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    # rank within the expert: position in the sorted order minus the start of
    # the expert's run (integer counts, exact)
    counts = torch.nn.functional.one_hot(e_sorted, n_experts).sum(dim=1)  # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(s * top_k, device=x.device)[None, :] - torch.gather(starts, 1, e_sorted)
    slot_sorted = torch.where(rank < cap, e_sorted * cap + rank,
                              torch.full_like(rank, n_experts * cap))
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)  # a permutation
    return slot, top_p.reshape(g, s * top_k)


class MoE(nn.Module):
    """x (B, S, d) -> (B, S, d); every batch row routed independently."""

    def __init__(self, d: int, ff: int, n_experts: int, top_k: int, act: str, *,
                 capacity_factor: float, shared_ff: int = 0, mode: str = "replicate",
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        if mode not in ("ep", "tp", "replicate"):
            raise ValueError(f"MoE layout {mode!r}: one of 'ep', 'tp', 'replicate'")
        self.n_experts, self.top_k, self.act, self.mode = n_experts, top_k, act, mode
        self.capacity_factor = capacity_factor
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.router = param(ninit((d, n_experts), generator=generator, dtype=torch.float32,
                                  device=device))
        self.w_up = param(ninit((n_experts, d, ff), **kw))
        self.w_down = param(ninit((n_experts, ff, d), **kw))
        self.w_gate = (param(ninit((n_experts, d, ff), **kw))
                       if act in ("swiglu", "geglu") else None)
        self.shared = MLP(d, shared_ff, act, **kw) if shared_ff else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a mesh every leaf is gathered over ``data`` where it is
        used (FSDP); on ``model`` > 1 the ``ep`` and ``tp`` layouts run this
        rank's part and sum the partials over ``model`` (the module
        docstring)."""
        b, s, d = x.shape
        e, k = self.n_experts, self.top_k
        cap = capacity(s, k, self.capacity_factor, e)
        split = self.mode != "replicate" and tp.model_axis().size > 1
        xs, router = ((tp.copy_to_model(x), tp.copy_to_model(self.router)) if split
                      else (x, self.router))
        w_up, w_down = tp.weight(self, "w_up"), tp.weight(self, "w_down")
        w_gate = tp.weight(self, "w_gate") if self.w_gate is not None else None
        slot, gate = route_group(xs, router, k, cap, e)
        if split and self.mode == "ep":
            # this rank's experts [lo, lo + n) (its block of the ceiling split,
            # zero-padded past E): their slots move to the front of its buffer,
            # every other choice to its discarded row
            per = w_up.shape[0]
            lo = tp.model_axis().rank * per
            n = max(0, min(e, lo + per) - lo)
            w_up, w_down = w_up[:n], w_down[:n]
            w_gate = w_gate[:n] if w_gate is not None else None
            local = slot - lo * cap
            slot = torch.where((local >= 0) & (local < n * cap), local,
                               torch.full_like(local, n * cap))
            e = n
        rows = torch.arange(b, device=x.device)[:, None]
        src = torch.arange(s, device=x.device).repeat_interleave(k)  # token of each choice
        buf = x.new_zeros((b, e * cap + 1, d))
        buf[rows, slot] = xs[:, src]  # dropped choices all land in the discarded last row
        eb = buf[:, :-1].reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
        if w_gate is not None:
            h = act_fn(self.act, torch.bmm(eb, w_gate)) * torch.bmm(eb, w_up)
        else:
            h = act_fn(self.act, torch.bmm(eb, w_up))
        out_e = torch.bmm(h, w_down).reshape(e, b, cap, d).transpose(0, 1)
        out_e = torch.cat([out_e.reshape(b, e * cap, d), x.new_zeros((b, 1, d))], dim=1)
        contrib = out_e[rows, slot] * gate[..., None].to(out_e.dtype)  # (B, S k, d)
        out = contrib.reshape(b, s, k, d).sum(dim=2)
        if split:
            out = tp.reduce_from_model(out)
        if self.shared is not None:  # the block's own input: its MLP copies it to model
            out = out + self.shared(x)
        return out
