"""``fit``: ``FalkonRegressor(sampler=BlessSampler(...)).fit`` on the resident
training rows, then ``.predict`` on the held-out rows. With ``split`` (a
traced run) the fit is split into ``sampler.sample``, a synchronize, then
``fit(center_set=...)`` and the predict, each timed in a span."""
from __future__ import annotations

import time

from torch.profiler import record_function

from portbench import jobs, pricing
from portbench.reference.entries.fit import FitOutputs


def run(job: jobs.Runner, seed: int, split: bool) -> tuple[FitOutputs, dict]:
    p, cfg = jobs.program(), job.config
    x, y = job.rows.x, job.rows.y
    sampler = job.sampler()
    est = p["FalkonRegressor"](cfg["kernel"], sampler=sampler, sigma=cfg["sigma"],
                               config=job.fit_config())
    spans = {}
    if split:
        t0 = time.perf_counter()
        with record_function("pb.sampler"):
            cs = sampler.sample(seed, x, est.kernel, backend=job.backend)
            jobs.sync(job.device)
        t1 = time.perf_counter()
        with record_function("pb.solver"):
            est.fit(x, y, center_set=cs)
            pred = est.predict(job.rows.x_test)
            jobs.sync(job.device)
        spans = {"sampler": t1 - t0, "solver": time.perf_counter() - t1}
    else:
        est.fit(x, y, key=seed)
        pred = est.predict(job.rows.x_test)
    m = int(est.center_set_.count)
    return FitOutputs(levels=jobs.levels_of(sampler), centers_idx=est.center_set_.idx[:m].cpu(),
                      pred=pred.cpu()), spans


def price(config: dict, traffic: dict, rows, out: FitOutputs) -> dict:
    n, d = rows.x.shape
    m, iters = out.levels[-1].count, config["iters"]
    rls = jobs.ladder_work(rows, out)
    job = (rls + pricing.falkon(n, m, d, 1, iters)
           + pricing.knm_matvec(rows.x_test.shape[0], m, d, 1))
    return {"job": job, "pb.knm_quadratic": pricing.knm_quadratic(n, m, d, 1).times(iters),
            "pb.rls_scores": rls}
