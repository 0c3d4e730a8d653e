"""Deterministic, resumable data pipeline.

The port of ``repro.data.pipeline``. Every batch is a pure function of
(seed, step): a restarted job replays identically from its checkpoint step
with no pipeline state to save. Each batch is drawn on the CPU from a
``torch.Generator`` seeded from (seed, step), then moved to ``device``, so
the CPU and the card get the same batch. The reference draws with JAX's
threefry, which torch cannot reproduce: the two packages' batches agree in
distribution, not in value (ROADMAP, "RNG").

Under a mesh each batch rank takes its rows: ``shard=(i, n)`` keeps rows
[i B / n, (i + 1) B / n) of the full batch (drawn whole, so the ranks'
rows together are the one-rank batch; B must divide by n).

``SyntheticLM`` produces learnable sequences (each next token is
perm[token] with probability 1 - noise, uniform otherwise, the permutation
drawn from the seed) so that a training loss falls; ``TokenPipeline`` is
the uniform-random load generator.
"""
from __future__ import annotations

import dataclasses

import torch

_MIX = 0x9E3779B97F4A7C15  # splits (seed, step) into well-separated generator seeds


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed * _MIX + step) % (1 << 63))


def _to(batch: dict, device: str, shard: tuple[int, int] = (0, 1)) -> dict:
    """The rows of ``shard`` (index, count) of ``batch``, on ``device``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: batches go to the card unless given device='cpu'")
    i, n = shard
    rows = next(iter(batch.values())).shape[0]
    if rows % n or not 0 <= i < n:
        raise ValueError(f"a batch of {rows} rows does not split into {n} (shard {i})")
    per = rows // n
    return {k: v[i * per:(i + 1) * per].to(device) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    device: str = "cuda"
    shard: tuple[int, int] = (0, 1)

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"} (batch, seq) int64, labels the next tokens
        (the shard's rows)."""
        toks = torch.randint(0, self.vocab_size, (self.batch, self.seq + 1),
                             generator=_generator(self.seed, step))
        return _to({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, self.device, self.shard)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Next token = perm[token] with probability 1 - noise, uniform else."""

    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    noise: float = 0.1
    device: str = "cuda"
    shard: tuple[int, int] = (0, 1)

    def _rule(self) -> torch.Tensor:
        """The permutation (vocab_size,) int64, on the CPU."""
        return torch.randperm(self.vocab_size, generator=torch.Generator().manual_seed(self.seed))

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"} (batch, seq) int64 of one chain per row (the
        shard's rows)."""
        perm = self._rule()
        g = _generator(self.seed + 1, step)
        tok = torch.randint(0, self.vocab_size, (self.batch,), generator=g)
        rand = torch.randint(0, self.vocab_size, (self.seq + 1, self.batch), generator=g)
        use_rand = torch.rand((self.seq + 1, self.batch), generator=g) < self.noise
        seqs = [tok]
        for t in range(self.seq + 1):
            tok = torch.where(use_rand[t], rand[t], perm[tok])
            seqs.append(tok)
        toks = torch.stack(seqs, dim=1)  # (batch, seq + 2)
        return _to({"tokens": toks[:, :self.seq], "labels": toks[:, 1:self.seq + 1]},
                   self.device, self.shard)
