"""CPU tests of the benchmark at tiny sizes: files found by name, every entry
and the reference, the pricing arithmetic, the trace reader, the exit
without a card, and which modules a run's imports load.

    python -m pytest -q portbench/tests
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import data, harness, jobs, pricing, tracing  # noqa: E402
from portbench.reference import judge, krr  # noqa: E402
from portbench.tests import tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = tiny.TINY
SEED = 2 ** 31 + 11


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_its_files_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    numbers = judge.entry(c.traffic["entry"]).NUMBERS
    assert c.limits and set(c.limits) <= set(numbers)
    for key in ("rows", "held_out", "d", "sigma", "lam", "iters", "bless", "reduced"):
        assert key in c.config
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "peak_gb", c.traffic["time_metric"]} <= names
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (ROOT / "portbench" / "traffic")
                                           .glob("*.json")))
def test_every_traffic_file_names_an_entry_found_by_name(traffic):
    t = json.loads((ROOT / "portbench" / "traffic" / f"{traffic}.json").read_text())
    program_side, reference_side = jobs.entry(t["entry"]), judge.entry(t["entry"])
    assert callable(program_side.run) and callable(program_side.price)
    assert callable(reference_side.judge) and callable(reference_side.produce)
    assert set(judge.LADDER) <= set(reference_side.NUMBERS)


def test_benchmark_json_names_and_metrics_follow_the_rules():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert 0 < e2e["setup_s"]["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("entry", ["fit", "sample", "sweep"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_each_entry_is_correct(entry, trace):
    res = harness.run_cell(tiny.cell(harness, entry), SEED, tiny.ONE_JOB, trace, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if not trace:
        assert {"setup_s", "peak_gb"} <= set(res["metrics"])


@pytest.mark.parametrize("entry", ["fit", "sample", "sweep"])
def test_the_tf32_control_in_the_programs_place_is_not_correct(entry):
    cell = tiny.cell(harness, entry)
    control = harness.run_cell(cell, SEED, tiny.ONE_JOB, False, device="cpu", control="tf32")
    assert not control["correct"], control["checks"]
    assert all(math.isfinite(c["value"]) for c in control["checks"].values())
    fp32 = harness.run_cell(cell, SEED, tiny.ONE_JOB, False, device="cpu", control="fp32")
    assert fp32["correct"], fp32["checks"]


def test_the_judge_reads_zero_on_its_own_fp64_outputs():
    cell = tiny.cell(harness, "fit")
    rows = data.make_split(TINY, 6, torch.device("cpu"))
    out = judge.produce("fit", rows, TINY, cell.traffic, 77, krr.FP64)
    got = judge.judge("fit", rows, TINY, cell.traffic, 77, out)
    assert got["draw_shift"] == 0.0 and got["weight_gap"] < 1e-6 and got["pred_gap"] < 1e-6


def test_a_ladder_of_other_draws_reads_inf_or_mismatch():
    cell = tiny.cell(harness, "sample")
    rows = data.make_split(TINY, 6, torch.device("cpu"))
    out = judge.produce("sample", rows, TINY, cell.traffic, 78, krr.FP64)
    got = judge.judge("sample", rows, TINY, cell.traffic, 79, out)
    assert got["draw_shift"] > 1e-3 or math.isinf(got["weight_gap"])


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -9])
    assert krr.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9]


def test_pricing_against_hand_worked_counts():
    # K2 at (10^6, 10^4, d 18, k 1): 40 contraction and 5 elementwise operations a pair
    w = pricing.knm_quadratic(10 ** 6, 10 ** 4, 18, 1)
    assert w.contraction == 40e10 and w.elementwise == 5e10
    assert w.bytes == 4 * (18e6 + 18e4 + 2e4)
    assert w.least_s() == pytest.approx(40e10 / 495e12)
    # bytes bound the Gram block K(X, Z) written out
    g = pricing.gram(10 ** 6, 10 ** 4, 18)
    assert g.least_s() == pytest.approx(4 * (18e6 + 18e4 + 1e10) / 3.35e12)
    masked = pricing.knm_quadratic(100, 10, 2, 5, masked=True)
    assert masked.elementwise == 5 * 100 * 10 + 100 * 5
    assert pricing.eigh(3).contraction == pytest.approx(36.0)
    r = pricing.rls_scores(10, 4, 2)
    assert r.contraction == 2 * 4 * 4 * 2 + 64 / 3 + 2 * 10 * 4 * 2 + 10 * 16
    assert pricing.rls_scores(10, 0, 2) == pricing.NONE
    f = pricing.falkon(50, 5, 3, 1, 4)
    assert f.contraction == pytest.approx(
        2 * 25 * 3 + 4 * 125 / 3 + (2 * 250 * 3 + 2 * 250) + 4 * (2 * 250 * 3 + 4 * 250 + 6 * 25))


def test_the_trace_reader_on_a_hand_made_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.knm_quadratic", "ts": 10, "dur": 5,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 11, "dur": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41, "dur": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 12, "dur": 20, "tid": 7,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 42, "dur": 8, "tid": 7,
         "args": {"correlation": 8}},
        # a library's kernel launched through the driver API inside a span
        {"ph": "X", "cat": "user_annotation", "name": "pb.rls_scores", "ts": 60, "dur": 10,
         "tid": 1},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 61, "dur": 1, "tid": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "trsm", "ts": 70, "dur": 6, "tid": 7,
         "args": {"correlation": 9}},
        # no recorded launch, and half of it past the window
        {"ph": "X", "cat": "kernel", "name": "lost", "ts": 96, "dur": 8, "tid": 7,
         "args": {"correlation": 10}},
    ]
    t = tracing.Trace(ev)
    assert t.window_s() == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(38e-6)
    assert t.span_device_s("pb.knm_quadratic") == pytest.approx(20e-6)
    assert t.span_device_s("pb.rls_scores") == pytest.approx(6e-6)
    launched, total = t.coverage()
    assert launched == pytest.approx(34e-6) and total == pytest.approx(38e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(20e-6)]
    assert dict(b["idle_gaps"]) == {"pb.window": pytest.approx(22e-6),
                                    "pb.rls_scores": pytest.approx(20e-6),
                                    "pb.window / aten::item": pytest.approx(20e-6)}


def test_a_reader_that_finds_nothing_returns_none():
    view = harness.Window("sample", [], [], 1.0, None)
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"])(view) is None


def test_mfu_reads_the_untraced_jobs_and_a_roofline_its_own_span():
    from portbench import readers
    tera = pricing.Work(contraction=495e12)
    view = harness.Window("fit", [], [{"job": tera, "pb.knm_quadratic": tera}], 10.0, None,
                          [{"job": tera}, {"job": tera}], 4.0)
    assert readers.mfu(view, "fit") == pytest.approx(50.0)
    assert readers.mfu(view, "sweep") is None
    assert readers.roofline(view, "pb.knm_quadratic") is None  # no trace to read


def test_run_exits_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        "susy.fit", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_exits_in_a_tree_without_the_program(tmp_path):
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "susy.fit", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


IMPORT_ALL = """
import importlib, pathlib, sys
root = pathlib.Path({root!r})
sys.path[:0] = [str(root), str(root / "src")]
import runpy
for mod in ["portbench.run", "portbench.harness", "portbench.calibrate", "portbench.readers",
            "portbench.faults"]:
    importlib.import_module(mod)
from portbench import harness, jobs
from portbench.reference import judge
jobs.program()
for f in sorted((root / "portbench" / "entries").glob("[a-z]*.py")):
    jobs.entry(f.stem), judge.entry(f.stem)
for f in sorted((root / "portbench" / "metrics").glob("*.py")):
    harness.reader(f.stem)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

IMPORT_REFERENCE = """
import pathlib, sys
sys.path.insert(0, {root!r})
import portbench.reference.judge, portbench.reference.krr
for f in sorted((pathlib.Path({root!r}) / "portbench" / "reference" / "entries").glob("[a-z]*.py")):
    portbench.reference.judge.entry(f.stem)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300, check=True)
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    r = subprocess.run([sys.executable, "-c", IMPORT_REFERENCE.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300, check=True)
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
