#!/usr/bin/env python3
"""Run a cell several times, one process per run, as the check does.

    python3 cardbench/sets.py --workload <name> --seeds 1,2,3 [--seconds 30] \
        [--trace 0] [--out chiprun_out/sets.jsonl]

Each run is ``cardbench/run.py`` in a process of its own; its last line, exit
code, wall seconds and the end of its standard error are appended to
``--out`` as one JSON line, and a summary is printed: per metric the values,
their median and the spread between the quartiles as a share of the median
(``statistics.quantiles(values, n=4)``), the measure the bounds are set from.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="30")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default="chiprun_out/sets.jsonl")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    print(f"card: {card_line()}", flush=True)
    values = {}
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, str(RUN), "--workload", args.workload,
                            "--seed", seed, "--seconds", args.seconds,
                            "--trace", args.trace], capture_output=True, text=True,
                           timeout=1500)
        wall = time.perf_counter() - t
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        try:
            line = json.loads(last)
        except json.JSONDecodeError:
            line = None
        rec = dict(workload=args.workload, seed=int(seed), trace=int(args.trace), rc=p.returncode,
                   wall_s=wall, line=line, stderr=p.stderr[-3000:])
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = {k: round(v["value"], 4) for k, v in (line or {}).get("metrics", {}).items()}
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f} s correct "
              f"{(line or {}).get('correct')} {short} checks {(line or {}).get('checks')}",
              flush=True)
        if p.returncode != 0 or line is None:
            print(p.stderr[-3000:], flush=True)
        for k, v in short.items():
            values.setdefault(k, []).append(v)
    for k, v in values.items():
        s = spread(v)
        print(f"{k}: median {statistics.median(v)} spread {s} values {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
