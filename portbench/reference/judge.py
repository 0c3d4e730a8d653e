"""The comparison that decides ``correct``: what every entry shares, and the
finder of each entry's own comparison, ``reference/entries/<entry>.py``.

A job's outputs (an ``Outputs``) are judged against the plain reference in
fp64 on the same rows, from the job's own seed. Every entry runs the BLESS
ladder, judged alike (``ladder_gaps``): the reference replays the job's
draws level by level from the job's own previous level (the ladder's
state), and reads the normwise relative gap of each level's center weights
(``weight_gap``) and the largest and the mean shift of its CDF that the
job's draws need (``draw_shift``, ``draw_shift_mean``), the largest over
the levels. An entry's module adds its own numbers (``NUMBERS``), its
``judge`` and its ``produce``: the reference's own outputs in another
arithmetic, which with "tf32" is the control.

An output without the algorithm's structure reads ``inf`` on every number.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import sys

import torch

from . import krr
from .krr import FP64, Arith, Level, Mismatch

Tensor = torch.Tensor

#: the ladder's numbers, which every entry reads
LADDER = ("weight_gap", "draw_shift", "draw_shift_mean")


def entry(name: str):
    """The module ``reference/entries/<name>.py``: ``NUMBERS``, ``judge``, ``produce``."""
    return importlib.import_module(f"portbench.reference.entries.{name}")


@dataclasses.dataclass
class Outputs:
    """What one job produced, on the host; an entry adds its own fields."""

    levels: list[Level]
    centers_idx: Tensor | None = None  # the rows the solver used as centers


def job_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


def sweep_generators(seed: int) -> tuple[torch.Generator, torch.Generator]:
    """(centers, folds): two generators drawn from the job's seed, as the
    sweep derives them."""
    seeds = torch.randint(0, 2 ** 62, (2,), generator=job_generator(seed))
    return tuple(torch.Generator(device="cpu").manual_seed(int(s)) for s in seeds)


def fold_ids(gen: torch.Generator, n: int, folds: int) -> Tensor:
    """A random permutation dealt round-robin into ``folds`` folds."""
    perm = torch.randperm(n, generator=gen)
    deal = torch.remainder(torch.arange(n, dtype=torch.int32), folds)
    return torch.empty((n,), dtype=torch.int32).scatter_(0, perm, deal)


def ladder_gaps(rows, config: dict, gen: torch.Generator, out: Outputs) -> dict:
    """The ladder's numbers (``LADDER``) of a job's levels, its draws from ``gen``."""
    _, gaps = krr.ladder(rows.x, config["sigma"], config["bless"], gen, FP64, follow=out.levels)
    return gaps


def centers(rows, out: Outputs) -> tuple[Tensor, Tensor, Tensor]:
    """(indices, rows, weights) of the ladder's final level, which must be
    the centers the solver used."""
    final = out.levels[-1]
    idx = final.idx[:final.count]
    if out.centers_idx is None or not torch.equal(out.centers_idx, idx):
        raise Mismatch("the solver's centers are not the ladder's final level")
    return idx, rows.x[idx.to(rows.x.device)], final.weight[:final.count].to(rows.x.device)


def reference_centers(rows, levels: list[Level]) -> tuple[Tensor, Tensor, Tensor]:
    """(indices, rows, weights) of a reference ladder's final level."""
    final = levels[-1]
    idx = final.idx[:final.count]
    x = rows.x
    return idx, x[idx.to(x.device)], final.weight[:final.count].to(x.device)


def judge(name: str, rows, config: dict, traffic: dict, seed: int, out: Outputs) -> dict:
    """The numbers (``entry(name).NUMBERS``) of one job's outputs."""
    mod = entry(name)
    try:
        return mod.judge(rows, config, traffic, seed, out)
    except (Mismatch, ArithmeticError, IndexError, RuntimeError) as e:
        print(f"judge: the outputs of job seed {seed} cannot be compared: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return {number: math.inf for number in mod.NUMBERS}


def produce(name: str, rows, config: dict, traffic: dict, seed: int, ar: Arith) -> Outputs:
    """The reference's own outputs for one job, in the arithmetic ``ar``."""
    return entry(name).produce(rows, config, traffic, seed, ar)
