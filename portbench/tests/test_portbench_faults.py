"""A run whose timed path is broken underneath must come out not correct.

Each test skips the look for a card and drives the rest of a run at a tiny
size on the CPU, with one of ``portbench.faults`` planted in the program for
the test only: a step that returns its state unchanged; half of the batch
left out and the mean taken over the rest; an answer altered where it is
produced. The cells run on one card, so there is no exchange between chips
to leave out. The same run unbroken is correct.

    python -m pytest -q portbench/tests
"""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import faults, harness  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from repro_torch.core import TorchBackend  # noqa: E402


def run(entry: str, seed: int = 2 ** 31 + 3) -> dict:
    return harness.run_cell(tiny.cell(harness, entry), seed, tiny.ONE_JOB, False, device="cpu")


@pytest.mark.parametrize("entry", ["fit", "sample", "sweep"])
def test_the_unbroken_tiny_run_is_correct(entry):
    res = run(entry)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("entry", ["fit", "sample", "sweep"])
def test_a_fault_underneath_makes_the_run_not_correct(entry, fault):
    with faults.plant(fault, entry, TorchBackend):
        res = run(entry)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_gone_after_its_block(fault):
    before = {k: getattr(TorchBackend, k, None) for k in ("rls_scores", "knm_quadratic",
                                                         "knm_matvec")}
    with faults.plant(fault, "fit", TorchBackend):
        pass
    with faults.plant(fault, "sample", TorchBackend):
        pass
    assert before == {k: getattr(TorchBackend, k, None) for k in before}
    assert "rls_scores" not in vars(TorchBackend)
