"""Batched serving: the parallel prompt forward and continuous-batching decode.

The port of the reference's ``repro.serving.engine``. ``prefill_logits`` is
the parallel prompt forward (``LM.forward``: K8 in the attention layers and
K9 in the Mamba layers on the card). ``ServeEngine`` is the reference's
minimal continuous-batching loop: fixed B slots with per-slot positions and
lengths, greedy sampling, prompts fed through the decode path token by
token (so it reaches neither kernel), slot recycling on completion. Its
semantics are the reference's step for step, including what each decode
step does to the caches of the other slots (ROADMAP C).

Under a mesh (``sharding.serve_ctx``'s layouts) all three run on every
rank: ``prefill_logits`` and ``prefill`` take the rank's batch rows and
give its rows and vocabulary block; ``ServeEngine`` runs the same requests
on every rank, each stepping its batch rows, samples the greedy token over
the vocabulary split across ``model`` and gathers the tokens over the
batch axes, so every rank records the same outputs.
"""
from __future__ import annotations

import torch

from ..models.model import LM
from ..sharding import collectives as tp
from ..sharding.rules import under_mesh_ctx


def sample_greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """argmax over the real vocabulary (padded columns masked to -inf).
    Under a mesh ``logits`` is the rank's vocabulary block and the argmax
    is taken over ``model`` (ties to the lower index)."""
    lo = tp.model_axis().rank * logits.shape[-1]
    valid = torch.arange(lo, lo + logits.shape[-1], device=logits.device) < vocab_size
    masked = torch.where(valid, logits, logits.new_full((), float("-inf")))
    if tp.model_axis().size == 1:
        return torch.argmax(masked, dim=-1)
    top, idx = torch.max(masked, dim=-1)
    return tp.argmax_over_model(top, idx + lo)


def prefill(lm: LM, tokens: torch.Tensor, cache_len: int) -> tuple[torch.Tensor, list]:
    """Sequential prompt pass that fills the decode cache of every mixer
    (KV rows for attention layers, conv window and SSD state for Mamba
    layers). tokens (B, S). Returns (last-token logits (B, Vp) fp32, cache)."""
    b, s = tokens.shape
    plan = tp.active()
    cache = lm.init_cache(b * (plan.batch_ways if plan is not None else 1), cache_len)
    logits = None
    for t in range(s):
        logits = lm.decode_step(cache, tokens[:, t], t, length=t + 1).float()
    return logits, cache


@torch.no_grad()
def prefill_logits(lm: LM, batch: dict) -> torch.Tensor:
    """Parallel prompt forward -> last-position logits (B, Vp)."""
    return lm.logits(lm(batch)[:, -1])


class ServeEngine:
    """Continuous batching over ``batch_slots`` fixed slots of ``max_len``
    cache rows, on ``device`` (the model's; "cuda" by default, raising
    without a card)."""

    def __init__(self, lm: LM, max_len: int, batch_slots: int, *, device: str = "cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: ServeEngine runs on the card unless given "
                               "device='cpu'")
        if lm.device.type != torch.device(device).type:
            raise ValueError(f"the model lies on {lm.device}, the engine was asked for {device}")
        self.lm, self.cfg = lm, lm.cfg
        self.max_len, self.batch_slots = max_len, batch_slots
        # the mesh ctx active now, under which every later call runs
        self._under = under_mesh_ctx(lambda fn, *args: fn(*args))
        self.cache = lm.init_cache(batch_slots, max_len)
        plan = tp.active()
        per = batch_slots // (plan.batch_ways if plan is not None else 1)
        first = plan.batch_index * per if plan is not None else 0
        self._rows = slice(first, first + per)  # the slots this rank steps
        dev = lm.device
        self.pos = torch.zeros((batch_slots,), dtype=torch.int64, device=dev)  # next write index
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((batch_slots,), dtype=torch.bool, device=dev)
        self.outputs: list[list[int]] = [[] for _ in range(batch_slots)]

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        """The greedy tokens (B,) of one decode step of every slot."""
        def run():
            r = self._rows
            logits = self.lm.decode_step(self.cache, tokens[r], self.pos[r],
                                         length=self.pos[r] + 1)
            return tp.gather_batch(sample_greedy(logits, self.cfg.vocab_size))

        return self._under(run)

    def add_request(self, slot: int, prompt: list[int]) -> None:
        """Feed a prompt through the decode path into this slot's cache and
        sample its first token. The prompt must be non-empty: the first
        token comes from the last prompt position's logits."""
        if not prompt:
            raise ValueError(
                f"add_request(slot={slot}): prompt must contain at least one "
                "token — an empty prompt has no logits to sample from")
        nxt = None
        for tok in prompt:
            toks = self.tokens.clone()
            toks[slot] = tok
            nxt = self._step(toks)
            self.pos[slot] += 1
        self.tokens[slot] = nxt[slot]
        self.active[slot] = True
        self.outputs[slot] = [int(self.tokens[slot])]

    def step(self) -> torch.Tensor:
        """One decode step for all slots (inactive slots decode garbage that
        is not recorded, the padded-slot trick). Returns the sampled (B,)."""
        nxt = self._step(self.tokens)
        self.pos += self.active.long()
        self.tokens = torch.where(self.active, nxt, self.tokens)
        for i, (on, t) in enumerate(zip(self.active.tolist(), nxt.tolist())):
            if on:
                self.outputs[i].append(t)
        return nxt

    def finish(self, slot: int) -> list[int]:
        self.active[slot] = False
        return self.outputs[slot]
