"""Batched serving: the parallel prompt forward and continuous-batching decode.

The port of the reference's ``repro.serving.engine``. ``prefill_logits`` is
the parallel prompt forward (``LM.forward``: K8 in the attention layers and
K9 in the Mamba layers on the card). ``ServeEngine`` is the reference's
minimal continuous-batching loop: fixed B slots with per-slot positions and
lengths, greedy sampling, prompts fed through the decode path token by
token (so it reaches neither kernel), slot recycling on completion. Its
semantics are the reference's step for step, including what each decode
step does to the caches of the other slots (ROADMAP C).
"""
from __future__ import annotations

import torch

from ..models.model import LM


def sample_greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """argmax over the real vocabulary (padded columns masked to -inf)."""
    valid = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    return torch.argmax(torch.where(valid, logits, logits.new_full((), float("-inf"))), dim=-1)


def prefill(lm: LM, tokens: torch.Tensor, cache_len: int) -> tuple[torch.Tensor, list]:
    """Sequential prompt pass that fills the decode cache of every mixer
    (KV rows for attention layers, conv window and SSD state for Mamba
    layers). tokens (B, S). Returns (last-token logits (B, Vp) fp32, cache)."""
    b, s = tokens.shape
    cache = lm.init_cache(b, cache_len)
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
        self.cache = lm.init_cache(batch_slots, max_len)
        dev = lm.device
        self.pos = torch.zeros((batch_slots,), dtype=torch.int64, device=dev)  # next write index
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((batch_slots,), dtype=torch.bool, device=dev)
        self.outputs: list[list[int]] = [[] for _ in range(batch_slots)]

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.lm.decode_step(self.cache, tokens, self.pos, length=self.pos + 1)

    def add_request(self, slot: int, prompt: list[int]) -> None:
        """Feed a prompt through the decode path into this slot's cache and
        sample its first token. The prompt must be non-empty: the first
        token comes from the last prompt position's logits."""
        if not prompt:
            raise ValueError(
                f"add_request(slot={slot}): prompt must contain at least one "
                "token — an empty prompt has no logits to sample from")
        logits = None
        for tok in prompt:
            toks = self.tokens.clone()
            toks[slot] = tok
            logits = self._step(toks)
            self.pos[slot] += 1
        self.tokens[slot] = sample_greedy(logits[slot], self.cfg.vocab_size)
        self.active[slot] = True
        self.outputs[slot] = [int(self.tokens[slot])]

    def step(self) -> torch.Tensor:
        """One decode step for all slots (inactive slots decode garbage that
        is not recorded, the padded-slot trick). Returns the sampled (B,)."""
        nxt = sample_greedy(self._step(self.tokens), self.cfg.vocab_size)
        self.pos += self.active.long()
        self.tokens = torch.where(self.active, nxt, self.tokens)
        for i, (on, t) in enumerate(zip(self.active.tolist(), nxt.tolist())):
            if on:
                self.outputs[i].append(t)
        return nxt

    def finish(self, slot: int) -> list[int]:
        self.active[slot] = False
        return self.outputs[slot]
