"""``fit``: the ladder, then FALKON (Def. 2, the same CG) on the job's final
center set and the held-out predictions;
``pred_gap`` = max |pred - ref| / max |ref|."""
from __future__ import annotations

import dataclasses

import torch

from .. import krr
from ..judge import LADDER, Outputs, centers, job_generator, ladder_gaps, reference_centers
from ..krr import FP64, Mismatch

NUMBERS = LADDER + ("pred_gap",)


@dataclasses.dataclass
class FitOutputs(Outputs):
    pred: torch.Tensor | None = None  # held-out predictions (n_test,)


def judge(rows, config: dict, traffic: dict, seed: int, out: FitOutputs) -> dict:
    sigma, n = config["sigma"], rows.x.shape[0]
    gaps = ladder_gaps(rows, config, job_generator(seed), out)
    _, z, a = centers(rows, out)
    kmm = krr.kmm_of(z, sigma, FP64)
    p, c, _ = krr.gram_sums(rows.x, rows.y, z, sigma, FP64)
    alpha = krr.falkon(krr.sums_operator(p, c, n, FP64), kmm, a, config["lam"], n,
                       config["iters"], FP64)
    ref = krr.predict(rows.x_test, z, alpha, sigma, FP64)[:, 0]
    if out.pred is None or out.pred.shape != ref.shape:
        raise Mismatch(f"predictions {None if out.pred is None else tuple(out.pred.shape)}, "
                       f"expected {tuple(ref.shape)}")
    pred = out.pred.to(ref.device).double()
    gaps["pred_gap"] = float(torch.max(torch.abs(pred - ref)) / torch.max(torch.abs(ref)))
    return gaps


def produce(rows, config: dict, traffic: dict, seed: int, ar: krr.Arith) -> FitOutputs:
    sigma, n = config["sigma"], rows.x.shape[0]
    levels, _ = krr.ladder(rows.x, sigma, config["bless"], job_generator(seed), ar)
    idx, z, a = reference_centers(rows, levels)
    op = krr.streamed_operator(rows.x, rows.y, z, sigma, ar)
    alpha = krr.falkon(op, krr.kmm_of(z, sigma, ar), a, config["lam"], n, config["iters"], ar)
    pred = krr.predict(rows.x_test, z, alpha, sigma, ar)[:, 0].float().cpu()
    return FitOutputs(levels=levels, centers_idx=idx, pred=pred)
