"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It runs on the card the process finds and
fails (exit code other than 0, no result line) without one, without the
program under ``src/``, or if JAX or the JAX package is loaded. The last
line of standard output is the result object; the numbers compared for
``correct`` are also the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: environment knobs of the program that would change the path it takes
PROGRAM_KNOBS = ("REPRO_BACKEND", "REPRO_STREAM_MIN_ROWS", "REPRO_SHARD_MIN_ROWS")


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "fp32"),
                    help="the plain reference in this arithmetic in the program's place "
                         "(tf32: the control, which has to come out not correct)")
    args = ap.parse_args(argv)

    for knob in PROGRAM_KNOBS:
        os.environ.pop(knob, None)
    src = ROOT / "src"
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    try:
        import repro_torch
    except ImportError as e:
        return fail(f"the program is not in this checkout ({e})", 2)
    if src not in pathlib.Path(repro_torch.__file__).resolve().parents:
        return fail(f"repro_torch comes from {repro_torch.__file__}, not {src}", 2)
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START, control=args.control)
    except harness.HarnessError as e:
        return fail(str(e), 4)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
