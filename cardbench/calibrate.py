#!/usr/bin/env python3
"""Readings that the correctness limits are set from, many seeds in one process.

    python3 cardbench/calibrate.py --workload <name> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--faults half_batch,...] [--fault-seeds 11] \
        [--seconds 4] [--out chiprun_out/calib.jsonl]

For each seed: the cell's own run (weights drawn from the seed, the
warm-up, a short window at the cell's load, the check of a sample against
the fp32 reference), the widest logit gap of the served tokens; for the
control seeds also the control's widest gap (the reference in float8 put
in the program's place).  Then each fault of ``harness/faults.py`` named in
``--faults``, planted under the cell's own run on each of ``--fault-seeds``:
its readings, which have to fail the cell's limits.  One JSON line per seed, on standard output and
appended to ``--out``.  The benchmark's own runs never run the control.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from harness import env  # noqa: E402

env.setup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="chiprun_out/calib.jsonl")
    args = ap.parse_args(argv)
    import torch
    from harness import cell_run, faults, judge, manifest
    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    runs = [(int(s), None) for s in args.seeds.split(",")]
    runs += [(int(s), f) for f in args.faults.split(",") if f
             for s in args.fault_seeds.split(",") if s]
    for seed, fault in runs:
        t = time.perf_counter()
        if fault is None:
            out = cell_run.run(cell, seed, args.seconds, False, t, dev, control=seed in controls)
        else:
            with faults.planted(fault):
                out = cell_run.run(cell, seed, args.seconds, False, t, dev)
        line = dict(workload=cell.name, seed=seed, fault=fault,
                    correct=judge.verdict(out["check"], cell.limits), **out["check"],
                    attempted=out["attempted"], failed=out["failed"], peak=out["peak"],
                    seconds=time.perf_counter() - t,
                    metrics={k: v["value"] for k, v in out["metrics"].items()})
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
