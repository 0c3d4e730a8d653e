"""Faults planted under the timed path, each of which a run has to come out
not correct with: a step that returns its state unchanged (``step``); half
of the batch left out, the mean taken over the rest (``half``); an answer
altered where it is produced (``answer``). The cells run on one card, so
there is no exchange between chips to leave out.

``plant(fault, entry, backend)`` patches the program (and ``backend``, the
seam class the run goes through: ``CudaBackend`` on the card,
``TorchBackend`` on the CPU) until the ``with`` block ends. The CPU tests
plant them at a tiny size; ``calibrate.py --fault`` reads them at a cell's
own size on the card.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = ("step", "half", "answer")


def _step(entry: str, backend) -> list:
    """fit, sweep: CG's last step left out (the iterate returned unchanged);
    sample: the ladder's last level returns the level below it unchanged."""
    from repro_torch.api import samplers
    from repro_torch.core import falkon

    if entry == "sample":
        real = samplers.bless

        def bless(*args, **kwargs):
            res = real(*args, **kwargs)
            res.levels[-1] = res.levels[-2]
            return res

        return [mock.patch.object(samplers, "bless", bless)]
    real_cg = falkon.cg
    return [mock.patch.object(falkon, "cg", lambda matvec, b, iters, **kw: real_cg(
        matvec, b, iters - 1, **kw))]


def _half(entry: str, backend) -> list:
    """fit, sweep: K_nM^T K_nM v over the first half of the rows, scaled up
    as their mean; sample: the first half of the candidates scored, the rest
    given their mean score."""
    if entry == "sample":
        real = backend.rls_scores

        def rls_scores(self, kernel, x_cand, z, z_mask, reg, lamn):
            half = max(1, x_cand.shape[0] // 2)
            s = real(self, kernel, x_cand[:half], z, z_mask, reg, lamn)
            return torch.cat([s, torch.full((x_cand.shape[0] - half,), float(torch.mean(s)),
                                            dtype=s.dtype, device=s.device)])

        return [mock.patch.object(backend, "rls_scores", rls_scores)]
    real = backend.knm_quadratic

    def knm_quadratic(self, kernel, x, z, *, mask=None):
        half = x.shape[0] // 2
        op = real(self, kernel, x[:half], z, mask=None if mask is None else mask[:half])
        return lambda v: op(v) * (x.shape[0] / half)

    return [mock.patch.object(backend, "knm_quadratic", knm_quadratic)]


def _answer(entry: str, backend) -> list:
    """fit: one held-out prediction; sample: one center of the last level;
    sweep: one fold's score."""
    from repro_torch.api import samplers, sweep

    if entry == "fit":
        real = backend.knm_matvec

        def knm_matvec(self, kernel, x, z, v):
            out = real(self, kernel, x, z, v).clone()
            out[0] += 0.5
            return out

        return [mock.patch.object(backend, "knm_matvec", knm_matvec)]
    if entry == "sample":
        real = samplers.bless

        def bless(key, x, *args, **kwargs):
            res = real(key, x, *args, **kwargs)
            idx = res.levels[-1].centers.idx
            idx[0] = (idx[0] + 1) % x.shape[0]
            return res

        return [mock.patch.object(samplers, "bless", bless)]
    real = sweep.KFoldSweep._scores

    def _scores(self, *args, **kwargs):
        scores, cs = real(self, *args, **kwargs)
        scores = scores.clone()
        scores[0, 0] *= 1.05
        return scores, cs

    return [mock.patch.object(sweep.KFoldSweep, "_scores", _scores)]


@contextlib.contextmanager
def plant(fault: str, entry: str, backend):
    """The program with ``fault`` planted under ``entry``'s timed path."""
    patches = {"step": _step, "half": _half, "answer": _answer}[fault](entry, backend)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield
