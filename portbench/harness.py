"""One run of one cell: set-up, a closed-loop window of jobs, the judgement
of a sample of its jobs against the plain reference, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration and traffic; the configuration's file, the
traffic's ``traffic/<name>.json``, the entry it drives (``entries/<entry>.py``
and its comparison ``reference/entries/<entry>.py``), the cell's
``limits/<cell>.json`` and each per-layer metric's reader
``metrics/<metric>.py`` hold the rest.

The window: one caller runs jobs back to back; a job starts only while the
elapsed time is under ``seconds``; the window runs from the first job's
start to the last job's end, closed by a synchronize. The time per job is
the window over the jobs completed. Set-up (imports, the kernels' build or
load, the rows, one warm-up job of job 0's seed) is everything before it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import random
import sys
import time

import torch
from torch.profiler import record_function

from . import data, jobs, tracing
from .reference import judge

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules that no process of the benchmark may hold (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TORCH_THREADS = 4
#: a traced run profiles the first seconds of its window (at most this many)
TRACE_SECONDS = 15.0
#: jobs of a window that are judged, drawn from the seed
JUDGED_JOBS = 1


class HarnessError(RuntimeError):
    """The run cannot produce a result line."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=w["chips"],
                config=json.loads((ROOT / cfg["file"]).read_text()),
                traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Window:
    """What the per-layer readers read: the cell's entry; the traced jobs,
    their priced work (``jobs.price``: a dict per job), the traced seconds
    and the trace; the jobs run after the profiler stopped (untraced, as in
    a run without ``--trace``), their priced work and their seconds."""

    entry: str
    jobs: list
    prices: list
    window_s: float
    trace: tracing.Trace | None
    rest_prices: list = dataclasses.field(default_factory=list)
    rest_s: float = 0.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def same(a, b) -> bool:
    """Equal bit for bit: tensors, numbers, and lists and dataclasses of them."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(same(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(u, v) for u, v in zip(a, b)))
    return a == b


def same_job(a: jobs.Job, b: jobs.Job) -> list[str]:
    """What differs between two jobs of one seed (launches, outputs bit for bit)."""
    diff = [] if a.launches == b.launches else [f"launches {a.launches} != {b.launches}"]
    return diff + [f.name for f in dataclasses.fields(a.out)
                   if not same(getattr(a.out, f.name), getattr(b.out, f.name))]


@dataclasses.dataclass
class Ran:
    """A closed window: the jobs completed, whether one failed, its seconds,
    the traced part (its jobs and seconds, the stopped profiler) and the
    seconds of the untraced rest after it."""

    done: list
    failed: int
    window_s: float
    peak: int
    traced: int = 0
    traced_s: float = 0.0
    rest_s: float = 0.0
    prof: object = None


def run_window(runner, seed: int, seconds: float, device: torch.device,
               traced_runner=None) -> Ran:
    """Jobs back to back while the elapsed time is under ``seconds`` (the
    first job starts the window). With ``traced_runner`` the first
    ``TRACE_SECONDS`` of them run through it under the profiler, inside a
    ``pb.window`` span, a fit split into its parts; the rest through
    ``runner``, whose seconds are counted from the profiler's stop. A job
    that raises is counted and ends the window."""
    ran = Ran(done=[], failed=0, window_s=0.0, peak=0,
              prof=None if traced_runner is None else tracing.profiler(device))
    if ran.prof is not None:
        ran.prof.start()
    jobs.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()

    def run_until(who, limit: float, split: bool) -> None:
        while not ran.failed and (not ran.done or time.perf_counter() - t0 < limit):
            try:
                ran.done.append(who.run(jobs.job_seed(seed, len(ran.done)), split=split))
            except Exception as e:  # noqa: BLE001 — counted, reported, ends the window
                print(f"job {len(ran.done)} failed: {type(e).__name__}: {e}", file=sys.stderr)
                ran.failed = 1

    if ran.prof is not None:
        with record_function(tracing.WINDOW):
            run_until(traced_runner, min(seconds, TRACE_SECONDS), True)
            jobs.sync(device)
        ran.traced, ran.traced_s = len(ran.done), time.perf_counter() - t0
        ran.prof.stop()
        jobs.sync(device)
    t_rest = time.perf_counter()
    run_until(runner, seconds, False)
    jobs.sync(device)
    t_end = time.perf_counter()
    ran.window_s, ran.rest_s = t_end - t0, t_end - t_rest
    ran.peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return ran


def judge_window(cell: Cell, rows, done: list, seed: int) -> dict:
    """Each number with a limit in the cell's limits file, with the limit:
    the largest over the jobs drawn from the seed (``JUDGED_JOBS`` of them)."""
    entry = cell.traffic["entry"]
    numbers = {name: 0.0 for name in judge.entry(entry).NUMBERS}
    pick = random.Random(seed).sample(range(len(done)), min(JUDGED_JOBS, len(done)))
    for i in pick:
        got = judge.judge(entry, rows, cell.config, cell.traffic, done[i].seed, done[i].out)
        for name, v in got.items():
            numbers[name] = math.inf if math.isnan(v) else max(numbers[name], v)
    return {name: {"value": numbers[name], "limit": limit} for name, limit in cell.limits.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, control: str | None = None) -> dict:
    """One run; returns the result object (``correct`` ... ``checks``).
    ``control`` ("tf32", "fp32") puts the plain reference in that arithmetic
    in the program's place, with no warm-up and no trace: with "tf32" it is
    the control, which has to come out not correct."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.set_num_threads(TORCH_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if control is not None and trace:
        raise HarnessError("a control run is not traced")
    traced_runner = None
    if control is not None:
        rows = data.make_split(cell.config, seed, device)
        runner = jobs.Control(cell.config, cell.traffic, rows, device, control)
    else:
        program = jobs.program()
        if device.type == "cuda":
            from repro_torch.kernels import build

            build.build()
            plain = None  # the entry points' own default on the card
        else:
            plain = program["TorchBackend"]()
        rows = data.make_split(cell.config, seed, device)
        runner = jobs.Runner(cell.config, cell.traffic, rows, device, backend=plain)
        warm = runner.run(jobs.job_seed(seed, 0))
        if trace:
            traced_runner = jobs.Runner(
                cell.config, cell.traffic, rows, device,
                backend=tracing.span_backend(plain or program["CudaBackend"]()))
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    setup_s = time.perf_counter() - t_start
    ran = run_window(runner, seed, seconds, device, traced_runner)
    del runner, traced_runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace and ran.done:
        diff = same_job(warm, ran.done[0])
        if diff:
            raise HarnessError(f"the traced job 0 differs from the untraced one: {diff}")
    checks = judge_window(cell, rows, ran.done, seed)
    correct = (not ran.failed and bool(ran.done)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(max(ran.peak, setup_peak))}
    result = {"correct": correct, "attempted": len(ran.done) + ran.failed,
              "failed": ran.failed, "metrics": metrics, "device": dev}
    if not trace:
        values = {"setup_s": setup_s, "peak_gb": ran.peak / 1e9}
        if ran.done:
            values[cell.traffic["time_metric"]] = ran.window_s / len(ran.done)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = tracing.Trace.of(ran.prof) if device.type == "cuda" else None

        def priced(done):
            return [jobs.price(cell.config, cell.traffic, rows, j.out) for j in done]

        view = Window(cell.traffic["entry"], ran.done[:ran.traced], priced(ran.done[:ran.traced]),
                      ran.traced_s, tr, priced(ran.done[ran.traced:]), ran.rest_s)
        for m in cell.per_layer:
            value = reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s()
            result["breakdown"] = tr.breakdown()
            attributed, device_s = tr.coverage()
            print(f"trace: {attributed!r} of {device_s!r} device seconds in the window "
                  f"were launched from a recorded host call", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise HarnessError(f"modules of the JAX package or JAX are loaded: {found}")
    result["checks"] = checks
    return result
