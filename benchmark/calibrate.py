#!/usr/bin/env python3
"""Readings the limits of a cell are set from: the numbers its check
compares, for the program as the configuration states it on many seeds,
and for the control on a few, all in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 1] [--fresh-rows] \
        [--reference-control] [--out f.jsonl]

The control is the program with its bfloat16 designs switched on (the
configuration states float32): the nearest precision below the stated one,
on the program's own path. Each seed is a whole run of the cell (set-up, a
short window, the check) and prints one JSON line; the cell's limits are
read from the lines, never used by them. The benchmark's own runs never
run this.

With ``--fresh-rows`` a configuration that draws its rows from a
``data_seed`` of its own (every cell: a run seed only flips feature
signs, so that every run seed poses one problem) draws them from each
run's seed instead: the lower readings then span fresh problems, whose
float32 solves stop at other points. With ``--reference-control`` the
reference also reads the numbers of a control that it computes itself
(where the program's own bfloat16 path leaves a number's stage in float32,
as the GAME fit's validation scoring).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTROL = {"design_dtype": "bfloat16"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fresh-rows", action="store_true")
    p.add_argument("--reference-control", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark import harness

    harness.set_host_threads(harness.workload(args.workload))

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def rows(seed):
        out = {"data_seed": seed} if args.fresh_rows else {}
        if args.reference_control:
            out["reference_control"] = True
        return out

    runs = [(int(s), "program", rows(int(s)))
            for s in args.seeds.split(",") if s]
    runs += [(int(s), "control", {**CONTROL, **rows(int(s))})
             for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for seed, side, overrides in runs:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result, obs = harness.run_cell(args.workload, seed,
                                           args.seconds, False, "cuda",
                                           overrides, started=t0)
            line = json.dumps({
                "workload": args.workload, "seed": seed, "side": side,
                "fresh_rows": args.fresh_rows,
                "correct": result["correct"], "units": obs.completed,
                "setup_s": obs.setup_seconds,
                "unit_s": obs.unit_seconds,
                "peak_bytes": obs.peak_bytes,
                "numbers": obs.numbers})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
