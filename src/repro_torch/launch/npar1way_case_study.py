"""NPAR1WAY case study — the paper's §5.2 evaluation, end to end.

    PYTHONPATH=src python -m repro_torch.launch.npar1way_case_study

Counterpart of ``examples/npar1way_case_study.py``, with the same report,
through the port's copy of the workload
(``repro_torch.perfdbg.workloads.npar1way``).  The workload is the paper's
program, numpy on the host CPU: it has no device to choose.

Reproduces: Fig. 16 (one cluster — no external bottleneck), Figs. 17-18
(CRNM severity: region 12 very-high, region 3 high -> CCCRs {3, 12}),
core {a4, a5} (network I/O + instruction count), Fig. 19 (+20% after
eliminating redundant common expressions; region 12's network I/O cannot
be eliminated — same as the paper).
"""
from __future__ import annotations

from repro_torch.perfdbg.workloads.npar1way import (NPAR1WAYWorkload,
                                                    npar1way_region_tree,
                                                    run_npar1way)


def main() -> int:
    tree = npar1way_region_tree()
    print("=" * 64)
    print("NPAR1WAY (parallel rank statistics) — original")
    print("=" * 64)
    rec, report, t_orig = run_npar1way(NPAR1WAYWorkload())
    print(report.external.render(tree))
    print()
    print(report.internal.render(tree))
    print()
    print("root causes (paper: core {a4, a5}):")
    print(" ", report.internal_root_causes.core.render())

    rec_o, rep_o, t_opt = run_npar1way(NPAR1WAYWorkload(eliminate_redundancy=True))
    ids = list(tree.ids())
    instr = rec.measurements().instructions[0]
    instr_o = rec_o.measurements().instructions[0]
    for rid in (3, 12):
        i = ids.index(rid)
        print(f"region {rid}: instructions -{(1 - instr_o[i]/instr[i])*100:.1f}% "
              f"(paper: -36.32% r3 / -16.93% r12)")
    print(f"\nprogram speedup: +{(t_orig/t_opt - 1)*100:.0f}%  (paper: +20%)")
    print("region 12 network I/O unchanged (paper: 'we fail to eliminate "
          "high network I/O quantity').")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
