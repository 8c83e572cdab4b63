"""Three-term roofline analysis from the dry-run's records, on the H100.

Counterpart of ``repro/launch/roofline.py``.  Per (arch x shape x mesh)
cell, from the per-device counts of ``launch/dryrun.py``:

    compute term    = per_device_flops / peak_flops          [s]
    memory term     = per_device_hbm_bytes / hbm_bw          [s]
    collective term = per_device_collective_bytes / link_bw  [s]

(equivalent to the global formulation: global_X / (chips * rate), since the
count is the per-device program).  Also reports MODEL_FLOPS (6*N_active*D
for train, 2*N*D prefill, 2*N*B decode), the useful-compute ratio
MODEL_FLOPS / counted flops, the dominant bottleneck, and a one-line
recommendation.

The constants are one NVIDIA H100 SXM5's, imported from
``perfdbg/attributes.py`` so that they live in one place: 989e12 bf16
FLOP/s, 3.35e12 B/s of HBM3, 450e9 B/s per direction of NVLink 4.  One link
rate for every collective is optimistic: a (16, 16) mesh of H100s spans 32
nodes of 8 cards, so most of a collective's bytes cross InfiniBand between
nodes, not NVLink.  The reference has one link constant too.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir dryrun_out/dryrun]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional

from ..perfdbg.attributes import HBM_BW, LINK_BW, PEAK_FLOPS

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"


def model_flops_global(rec: Dict) -> float:
    """MODEL_FLOPS per step: 6*N*D train; 2*N*D prefill; 2*N*B decode."""
    n_active = rec["active_params"]
    tokens = rec["global_batch"] * rec["seq_len"]
    if rec["mode"] == "train":
        return 6.0 * n_active * tokens
    if rec["mode"] == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * rec["global_batch"]      # decode: 1 new token


def cell_roofline(rec: Dict) -> Optional[Dict]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    hs = rec.get("hlo_stats")
    if not hs:
        return None
    chips = 1
    for d in rec.get("mesh_shape", []):
        chips *= d
    flops = hs["flops"]
    bytes_hbm = hs["bytes"]
    coll = hs["total_collective_bytes"]
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops_global(rec)
    useful = mf / max(flops * chips, 1.0)
    bound_time = max(terms.values())
    # roofline fraction: useful model flops per chip-second at the binding
    # resource vs peak (the score the perf loop drives up)
    frac = (mf / chips / PEAK_FLOPS) / bound_time if bound_time > 0 else 0.0
    rec_out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "mode": rec["mode"], "chips": chips,
        "per_device_flops": flops, "per_device_bytes": bytes_hbm,
        "per_device_collective_bytes": coll,
        "collective_breakdown": hs.get("collective_bytes", {}),
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": round(useful, 4),
        "roofline_fraction": round(frac, 4),
        "recommendation": _recommend(dominant, rec, terms),
    }
    return rec_out


def _recommend(dominant: str, rec: Dict, terms: Dict[str, float]) -> str:
    if dominant == "compute":
        return ("compute-bound: reduce remat recompute (wider checkpoint "
                "spacing) or shed non-matmul flops; already near the right "
                "regime for tensor-core utilization")
    if dominant == "memory":
        if rec["mode"] == "decode":
            return ("HBM-bound (expected for decode: weights+KV read per "
                    "token); shrink bytes via KV-cache quantization or "
                    "grouped reads; batch growth amortizes weights")
        return ("HBM-bound: the plain attention materializes score "
                "tensors through HBM — the flash kernel K1 removes "
                "O(S^2) traffic; also consider bf16 master/optimizer reads")
    return ("collective-bound: overlap all-gathers with compute "
            "(latency-hiding schedule), shard contracting dims to turn "
            "all-gather+matmul into matmul+reduce-scatter, or compress "
            "gradients (bf16) before the data-parallel all-reduce")


def build_table(dryrun_dir: pathlib.Path) -> List[Dict]:
    rows = []
    for p in sorted(dryrun_dir.glob("*.json")):
        rec = json.loads(p.read_text())
        row = cell_roofline(rec)
        if row:
            rows.append(row)
        elif rec.get("skipped"):
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "skipped": rec["skipped"]})
    return rows


def render_markdown(rows: List[Dict], mesh: str = "single") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant "
           "| useful | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped") or r.get("mesh") != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(RESULTS_DIR / "dryrun"))
    ap.add_argument("--out", default=str(RESULTS_DIR / "roofline.json"))
    args = ap.parse_args(argv)
    rows = build_table(pathlib.Path(args.dir))
    pathlib.Path(args.out).write_text(json.dumps(rows, indent=2))
    for mesh in sorted({r["mesh"] for r in rows if not r.get("skipped")},
                       key=("single", "multi").index):
        print(f"mesh: {mesh}")
        print(render_markdown(rows, mesh))
    n_dom = {}
    for r in rows:
        if not r.get("skipped"):
            n_dom[r["dominant"]] = n_dom.get(r["dominant"], 0) + 1
    print(f"\ncells: {len(rows)}  dominant-term counts: {n_dom}")
    print(f"written: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
