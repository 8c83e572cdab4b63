#!/usr/bin/env python3
"""Run one cell of the port's card benchmark once.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: sets up the cell named in ``BENCHMARK.json``
(the port's model on weights drawn from ``--seed`` on the card), warms one
batch of its shape, serves its traffic for ``--seconds``, checks a sample
of what it served against the plain fp32 reference, and prints one JSON
line last on standard output.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics with the device's busy time,
read from a profile of the same window.  Exits 2 without a result where
there is no card, too few cards, or the port (or JAX) is missing.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from harness import env  # noqa: E402

env.setup()
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str) -> int:
    print(f"cardbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import manifest
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} card(s), "
                    f"{torch.cuda.device_count()} found")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the port is missing: {e}")
    from harness import cell_run, judge
    dev = torch.device("cuda", 0)
    out = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), T_PROC0, dev)

    found = loaded_forbidden()
    if found:
        return fail(f"loaded after the window: {found}")
    check = out["check"]
    correct = judge.verdict(check, cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, "memory_peak_bytes": out["peak"]}
    if args.trace:
        device.update(busy_s=out["record"]["busy_s"], window_s=out["record"]["window_s"])
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {name: {"value": check[name], "limit": limit}
                      for name, limit in cell.limits.items()}
    line["checks"].update(served_tokens_compared=check["served"],
                          not_reference_first=check["mismatches"])
    if "dropped" in check:
        line["checks"]["capacity_drops_in_reference"] = check["dropped"]
    print(f"{check['served']} served tokens compared, {check['mismatches']} not the "
          f"reference's first", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr)
    for name, limit in cell.limits.items():
        print(f"check {name} {check[name]!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
