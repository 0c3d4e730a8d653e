"""``sample``: ``BlessSampler.sample`` on the resident training rows."""
from __future__ import annotations

from portbench import jobs
from portbench.reference.judge import Outputs


def run(job: jobs.Runner, seed: int, split: bool) -> tuple[Outputs, dict]:
    sampler = job.sampler()
    sampler.sample(seed, job.rows.x, job.kernel, backend=job.backend)
    return Outputs(levels=jobs.levels_of(sampler)), {}


def price(config: dict, traffic: dict, rows, out: Outputs) -> dict:
    rls = jobs.ladder_work(rows, out)
    return {"job": rls, "pb.rls_scores": rls}
