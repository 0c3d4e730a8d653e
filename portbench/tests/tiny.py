"""The tiny size the CPU tests run the cells at, and the limits that hold
there: sound runs of the program read far under them, the TF32 control and
the planted faults far over them."""
from __future__ import annotations

from portbench.reference import judge

TINY = {"rows": 2500, "held_out": 400, "d": 6, "kernel": "gaussian", "sigma": 1.5, "lam": 1e-3,
        "iters": 6, "bless": {"lam": 3e-2, "q": 2.0, "q1": 3.0, "q2": 3.0, "m_cap": 400}}
#: a sweep over lambdas at which fp32 stays close to fp64 at this size
TINY_LAMS = [1e-2, 1e-3]
LIMITS = {"weight_gap": 1e-4, "draw_shift": 1e-6, "draw_shift_mean": 1e-8, "pred_gap": 1e-2,
          "score_gap": 2e-3, "choice_regret": 1e-3}
#: shorter than one job: the window runs job 0 alone, so a seed gives one reading
ONE_JOB = 1e-3
CELLS = {"fit": "susy.fit", "sample": "susy.sample", "sweep": "susy.sweep"}


def cell(harness, entry: str):
    """The cell of ``entry`` at the tiny size, with the tiny limits."""
    c = harness.load_cell(CELLS[entry])
    c.config = dict(TINY)
    if entry == "sweep":
        c.traffic = dict(c.traffic, lams=TINY_LAMS)
    c.limits = {k: LIMITS[k] for k in judge.entry(c.traffic["entry"]).NUMBERS}
    return c
