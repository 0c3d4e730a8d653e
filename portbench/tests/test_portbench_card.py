"""Card-only tests of the benchmark (marked ``gpu``; they skip without a card).

A short traced run of each cell as it stands on the card: correct; the
traced job 0 (the seam wrapped in spans, the fit split in two) launches the
same kernels and gives the same bits as the untraced warm-up job of its seed
(``run_cell`` raises otherwise); and every device second in the traced
window comes from a launch that the trace recorded (the runtime's or the
driver's), so the spans' rooflines miss none of their work. On the card's
machine:

    python -m pytest -q -m gpu portbench/tests/test_portbench_card.py
"""
from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["susy.fit", "susy.sample", "susy.sweep"])
def test_a_short_traced_run_on_the_card_is_correct_and_dispatches_as_untraced(
        card, cell, capsys):
    res = harness.run_cell(harness.load_cell(cell), 2 ** 31 + 5, 2.0, True, device=card)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert res["metrics"], res
    said = [line.split() for line in capsys.readouterr().err.splitlines()
            if line.startswith("trace: ")]
    launched, total = float(said[-1][1]), float(said[-1][3])
    assert total > 0 and launched >= 0.999 * total, said
