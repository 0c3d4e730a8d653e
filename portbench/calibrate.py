"""The readings that the limits of ``limits/<cell>.json`` are set from, each
taken by a run of the cell (``harness.run_cell``) whose window holds one job.

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12
    python3 portbench/calibrate.py --workload <cell> --seeds 101-103 --control tf32
    python3 portbench/calibrate.py --workload <cell> --seeds 201 --fault step

Per seed: the cell's rows from the seed, the warm-up and one job, judged as
a run judges its window, with every number of the entry read (those that
the cell compares against their limits, the others against none).
``--control tf32`` puts the plain reference in TF32 in the program's place
(the control: it has to come out not correct);
``--fault`` plants one of ``faults.FAULTS`` under the program's timed path
(each has to come out not correct). One JSON line per run on standard
output, and with ``--out`` in that file too. The benchmark's runs do not
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: shorter than one job: the window runs job 0 alone
ONE_JOB = 1e-3


def seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control", choices=("tf32", "fp32"))
    ap.add_argument("--fault")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import faults, harness, jobs
    from portbench.reference import judge

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    if args.fault is not None and args.fault not in faults.FAULTS:
        print(f"calibrate: no fault {args.fault!r}; known: {faults.FAULTS}", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    # every number of the entry, those without a limit beside an infinite one
    cell.limits = {n: cell.limits.get(n, math.inf)
                   for n in judge.entry(cell.traffic["entry"]).NUMBERS}
    kind = args.control or (f"fault:{args.fault}" if args.fault else "program")
    sink = open(args.out, "a") if args.out else None
    for seed in seeds(args.seeds):
        planted = (faults.plant(args.fault, cell.traffic["entry"], jobs.program()["CudaBackend"])
                   if args.fault else contextlib.nullcontext())
        t0 = time.perf_counter()
        with planted:
            res = harness.run_cell(cell, seed, ONE_JOB, False, control=args.control)
        line = {"cell": cell.name, "kind": kind, "seed": seed, "correct": res["correct"],
                "numbers": {k: c["value"] for k, c in res["checks"].items()},
                "limits": {k: c["limit"] for k, c in res["checks"].items()},
                "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
