"""The one generator of jobs: a traffic file names the entry of the program
that each job drives, ``entries/<entry>.py``, and its parameters; the
configuration gives the sizes.

The sampler is ``BlessSampler`` with one addition, ``KeptLadder``: it keeps
the ladder that ``sample`` ran, so that every level can be judged. A job's
outputs are copied to the host when it ends, so nothing accumulates on the
card during a window. ``Control`` puts the plain reference, in a lower
precision, in the program's place.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib

import torch

from . import pricing
from .reference import judge
from .reference.judge import Outputs
from .reference.krr import Arith, Level

PROGRAM = None


def program():
    """The program's entry points, imported once (``repro_torch`` must be on
    ``sys.path``)."""
    global PROGRAM
    if PROGRAM is None:
        from repro_torch import kernels
        from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig, KFoldSweep
        from repro_torch.core import Backend, CudaBackend, TorchBackend, make_kernel

        @dataclasses.dataclass(frozen=True)
        class KeptLadder(BlessSampler):
            """``BlessSampler`` that keeps each ladder its ``sample`` ran."""

            kept: list = dataclasses.field(default_factory=list, compare=False, hash=False,
                                           repr=False)

            def sample(self, key, x, kernel, *, backend=None):
                result = self.ladder(key, x, kernel, backend=backend)
                self.kept.append(result)
                return result.final.centers

        PROGRAM = dict(kernels=kernels, KeptLadder=KeptLadder, FalkonRegressor=FalkonRegressor,
                       FitConfig=FitConfig, KFoldSweep=KFoldSweep, Backend=Backend,
                       CudaBackend=CudaBackend, TorchBackend=TorchBackend,
                       make_kernel=make_kernel)
    return PROGRAM


def entry(name: str):
    """The module ``entries/<name>.py``: ``run`` and ``price``."""
    return importlib.import_module(f"portbench.entries.{name}")


def job_seed(seed: int, i: int) -> int:
    """Job i's seed, drawn from (run seed, i)."""
    digest = hashlib.blake2b(f"{seed}:{i}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 62) - 1)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Job:
    """One finished job: its seed, outputs on the host, kernel launches, and
    (traced fits) host seconds of its parts."""

    seed: int
    out: Outputs
    launches: dict
    spans: dict


def levels_of(sampler) -> list[Level]:
    """The levels of the ladder that ``sampler`` (a ``KeptLadder``) ran last, on the host."""
    return [Level(lam=lvl.lam, idx=lvl.centers.idx.cpu(), weight=lvl.centers.weight.cpu(),
                  count=int(lvl.centers.count), d_h=lvl.d_h, m_h=lvl.m_h, r_h=lvl.r_h)
            for lvl in sampler.kept[-1].levels]


def ladder_work(rows, out: Outputs) -> pricing.Work:
    """The ladder's scoring, counted from (candidates, distinct centers of the
    level below) per level."""
    n, d = rows.x.shape
    sizes, prev = [], 0
    for lvl in out.levels:
        sizes.append((min(lvl.r_h, n), prev))
        prev = int(torch.unique(lvl.idx[:lvl.count]).shape[0])
    return pricing.ladder(sizes, d)


def price(config: dict, traffic: dict, rows, out: Outputs) -> dict:
    """The job's work by what it prices (``"job"``: all of it; ``"pb.<seam
    call>"``: the calls of that span), counted from the algorithm's sizes."""
    return entry(traffic["entry"]).price(config, traffic, rows, out)


class Runner:
    """Runs one cell's jobs on resident rows; ``backend`` is what the entry
    points are handed (None: their default on the card)."""

    def __init__(self, config: dict, traffic: dict, rows, device: torch.device, backend=None):
        self.config, self.traffic, self.rows, self.device = config, traffic, rows, device
        self.backend = backend
        self.entry = traffic["entry"]
        self.module = entry(self.entry)
        self.kernel = program()["make_kernel"](config["kernel"], sigma=config["sigma"])

    def sampler(self):
        b = self.config["bless"]
        return program()["KeptLadder"](lam=b["lam"], q=b["q"], q1=b["q1"], q2=b["q2"],
                                       m_cap=b.get("m_cap"))

    def fit_config(self):
        return program()["FitConfig"](lam=self.config["lam"], iters=self.config["iters"],
                                      backend=self.backend, device=self.device.type)

    def run(self, seed: int, *, split: bool = False) -> Job:
        """One job; ``split`` times its parts apart (a traced fit)."""
        kernels = program()["kernels"]
        kernels.reset_launch_counts()
        out, spans = self.module.run(self, seed, split)
        sync(self.device)
        return Job(seed, out, kernels.launch_counts(), spans)


class Control:
    """The plain reference in the program's place, in the arithmetic
    ``arith`` ("tf32": the control, which has to come out not correct)."""

    def __init__(self, config: dict, traffic: dict, rows, device: torch.device, arith: str):
        self.config, self.traffic, self.rows, self.device = config, traffic, rows, device
        self.entry, self.arith = traffic["entry"], Arith(arith)

    def run(self, seed: int, *, split: bool = False) -> Job:
        out = judge.produce(self.entry, self.rows, self.config, self.traffic, seed, self.arith)
        sync(self.device)
        return Job(seed, out, {}, {})
