"""``sample``: the BLESS ladder alone, judged level by level."""
from __future__ import annotations

from .. import krr
from ..judge import LADDER, Outputs, job_generator, ladder_gaps

NUMBERS = LADDER


def judge(rows, config: dict, traffic: dict, seed: int, out: Outputs) -> dict:
    return ladder_gaps(rows, config, job_generator(seed), out)


def produce(rows, config: dict, traffic: dict, seed: int, ar: krr.Arith) -> Outputs:
    levels, _ = krr.ladder(rows.x, config["sigma"], config["bless"], job_generator(seed), ar)
    return Outputs(levels=levels)
