"""``sweep``: ``KFoldSweep(lams=..., folds=...).run`` on the resident training
rows; the traffic file gives ``lams`` and ``folds``."""
from __future__ import annotations

from portbench import jobs, pricing
from portbench.reference.entries.sweep import SweepOutputs


def run(job: jobs.Runner, seed: int, split: bool) -> tuple[SweepOutputs, dict]:
    cfg, t = job.config, job.traffic
    sampler = job.sampler()
    res = jobs.program()["KFoldSweep"](
        kernel=cfg["kernel"], sampler=sampler, lams=tuple(t["lams"]), folds=t["folds"],
        sigma=cfg["sigma"], iters=cfg["iters"], backend=job.backend,
        device=job.device.type).run(job.rows.x, job.rows.y, key=seed)
    m = int(res.center_set.count)
    return SweepOutputs(levels=jobs.levels_of(sampler), centers_idx=res.center_set.idx[:m].cpu(),
                        scores=res.scores.cpu(), best_lam=res.best_lam,
                        fold_id=res.fold_id.cpu()), {}


def price(config: dict, traffic: dict, rows, out: SweepOutputs) -> dict:
    n, d = rows.x.shape
    m, iters = out.levels[-1].count, config["iters"]
    k, lams = traffic["folds"], len(traffic["lams"])
    rls = jobs.ladder_work(rows, out)
    per_lam = pricing.falkon(n, m, d, k, iters, masked=True) + pricing.knm_matvec(n, m, d, k)
    return {"job": rls + per_lam.times(lams),
            "pb.knm_quadratic_masked":
                pricing.knm_quadratic(n, m, d, k, masked=True).times(iters * lams),
            "pb.rls_scores": rls}
