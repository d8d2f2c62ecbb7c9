#!/usr/bin/env python3
"""The readings that a cell's limits are set from (checks/<cell>.json).

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--controls tf32 bfloat16] [--seconds 2] [--out FILE]

In one process, for each seed: the cell's pool, a short closed-loop window
at the cell's own load, and the calls the correctness check samples, as a
run makes them; then every number of those calls against the float64
reference (the program's readings), and the same numbers for the
reference computed in each control precision in the program's place (the
controls' readings).  Prints a JSON line a seed and, last, the largest
reading of the program and the smallest of each control for every number.
Not run by the benchmark's runs; it needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, default=3, help="the first n seeds also read the controls")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import checks, runner, spec
    from portbench.reference.plain import Precision

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cell = spec.load_cell(args.workload)
    call = cell.entry().load(cell.config, dev)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        pool = runner.make_pool(cell, seed, dev)
        call(pool[0])
        sampler = runner.Reservoir(cell.checks["calls"], seed)
        w = runner.window(call, pool, args.seconds, sampler, dev)
        samples = sampler.items
        row = {"seed": seed, "calls": w["calls"], "program": _worst(checks.call_numbers(cell, pool, samples))}
        for c in args.controls if len(rows) < args.control_seeds else ():
            row[c] = _worst(checks.control_numbers(cell, pool, samples, Precision(c)))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del pool, samples, sampler
    names = rows[0]["program"]
    summary = {"workload": args.workload, "seeds": args.seeds,
               "program_max": {n: max(r["program"][n] for r in rows) for n in names}}
    for c in args.controls:
        summary[f"{c}_min"] = {n: min(r[c][n] for r in rows if c in r) for n in names}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows + [summary]) + "\n")
    return 0


def _worst(per_call: list) -> dict:
    return {n: max(got[n] for got in per_call) for n in per_call[0]}


if __name__ == "__main__":
    sys.exit(main())
