"""``sweep``: the fold assignment, the ladder, then on the job's center set
each lambda's exact k-fold columns; ``score_gap`` = the largest relative gap
of a fold score, ``choice_regret`` = how much worse, by the reference's mean
scores, the job's chosen lambda is than the reference's."""
from __future__ import annotations

import dataclasses

import torch

from .. import krr
from ..judge import (LADDER, Outputs, centers, fold_ids, ladder_gaps, reference_centers,
                     sweep_generators)
from ..krr import FP64, Mismatch

NUMBERS = LADDER + ("score_gap", "choice_regret")


@dataclasses.dataclass
class SweepOutputs(Outputs):
    scores: torch.Tensor | None = None  # (lams, folds) held-out MSE
    best_lam: float | None = None
    fold_id: torch.Tensor | None = None


def _fold_scores(p, c, yy, sizes, alpha):
    """Each fold's held-out MSE from its own sums: (a P a - 2 a c + y y) / size."""
    quad = torch.einsum("fm,fmk,fk->f", alpha.T, p, alpha.T)
    lin = torch.einsum("fm,fm->f", alpha.T, c)
    return (quad - 2.0 * lin + yy) / sizes.to(p.dtype)


def judge(rows, config: dict, traffic: dict, seed: int, out: SweepOutputs) -> dict:
    sigma, lam_grid, folds = config["sigma"], traffic["lams"], traffic["folds"]
    x, n = rows.x, rows.x.shape[0]
    g_sample, g_fold = sweep_generators(seed)
    fid = fold_ids(g_fold, n, folds)
    if out.fold_id is None or not torch.equal(out.fold_id, fid):
        raise Mismatch("the folds are not the seed's")
    gaps = ladder_gaps(rows, config, g_sample, out)
    _, z, a = centers(rows, out)
    kmm = krr.kmm_of(z, sigma, FP64)
    p, c, yy = krr.gram_sums(x, rows.y, z, sigma, FP64, groups=fid, n_groups=folds)
    sizes = torch.bincount(fid.long(), minlength=folds).to(x.device)
    op = krr.sums_operator(p, c, n, FP64, holdout=True, sizes=sizes)
    ref = torch.stack([
        _fold_scores(p, c, yy, sizes, krr.falkon(op, kmm, a, lam, n, config["iters"], FP64))
        for lam in lam_grid]).cpu()
    if out.scores is None or out.scores.shape != ref.shape:
        raise Mismatch("the sweep's scores do not have one row per lambda, one column per fold")
    gaps["score_gap"] = float(torch.max(torch.abs(out.scores.double() - ref) / ref))
    mean = torch.mean(ref, dim=1)
    lams = [float(v) for v in lam_grid]
    if out.best_lam not in lams:
        raise Mismatch(f"the chosen lambda {out.best_lam} is not on the grid")
    chosen = mean[lams.index(out.best_lam)]
    gaps["choice_regret"] = float((chosen - torch.min(mean)) / torch.min(mean))
    return gaps


def produce(rows, config: dict, traffic: dict, seed: int, ar: krr.Arith) -> SweepOutputs:
    sigma, folds = config["sigma"], traffic["folds"]
    x, y, n = rows.x, rows.y, rows.x.shape[0]
    g_sample, g_fold = sweep_generators(seed)
    fid = fold_ids(g_fold, n, folds)
    levels, _ = krr.ladder(x, sigma, config["bless"], g_sample, ar)
    idx, z, a = reference_centers(rows, levels)
    kmm = krr.kmm_of(z, sigma, ar)
    fdev = fid.to(x.device)
    held = (fdev[:, None] == torch.arange(folds, device=x.device)[None, :]).to(torch.float32)
    op = krr.streamed_operator(x, y, z, sigma, ar, mask=1.0 - held)
    scores = []
    for lam in traffic["lams"]:
        alpha = krr.falkon(op, kmm, a, lam, n, config["iters"], ar)
        sq = (krr.predict(x, z, alpha, sigma, ar).float() - y[:, None]) ** 2
        scores.append(torch.sum(sq * held, dim=0) / torch.sum(held, dim=0))
    scores = torch.stack(scores).cpu()
    best = float(traffic["lams"][int(torch.argmin(torch.mean(scores, dim=1)))])
    return SweepOutputs(levels=levels, centers_idx=idx, scores=scores, best_lam=best, fold_id=fid)
