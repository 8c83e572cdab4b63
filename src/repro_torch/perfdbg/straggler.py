"""Straggler detection & mitigation driven by the paper's external-bottleneck
machinery (perfdbg layer: verdicts over core reports; gap-aware — a merged
pod view's masked rank is *missing*, never a fast outlier).

At pod scale, a slow host / thermally-throttled chip / asymmetric data shard
shows up exactly as the paper's *external bottleneck*: the per-shard region
vectors fall into >1 OPTICS cluster.  The majority cluster defines 'healthy';
minority/isolated ranks are stragglers, attributed by the rough-set core of
their decision table (e.g. core {instructions} => data imbalance — re-shard;
core {network_io} => link problem — drain and replace the host).

Mitigation mirrors the paper's ST fix (static -> dynamic dispatch by a
master): ``rebalance_weights`` computes a work-redistribution factor per
rank from region CPU times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import AnalysisReport, ExternalReport

SEVERITY_ALERT = 0.15   # S below this: log only (paper: balanced ST ~ 0.033)


@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    stragglers: Tuple[int, ...]          # rank ids outside the majority cluster
    majority: Tuple[int, ...]
    severity: float                      # the paper's S metric
    causes: Dict[int, Tuple[str, ...]]   # rank -> core attributes flagged
    action: str                          # none | rebalance | alert
    missing: Tuple[int, ...] = ()        # gap-masked ranks (no data shipped)

    def render(self) -> str:
        miss = f", missing={list(self.missing)}" if self.missing else ""
        if not self.stragglers:
            return f"no stragglers (S={self.severity:.4f}{miss})"
        lines = [f"stragglers: {list(self.stragglers)} (S={self.severity:.4f}, "
                 f"action={self.action}{miss})"]
        for r in self.stragglers:
            c = ", ".join(self.causes.get(r, ())) or "unattributed"
            lines.append(f"  rank {r}: {c}")
        return "\n".join(lines)


def detect(report: AnalysisReport,
           gap_ranks: Sequence[int] = ()) -> StragglerVerdict:
    """Classify ranks from one window's :class:`AnalysisReport`.

    ``gap_ranks`` are ranks whose shard was missing when the pod view was
    merged (``WindowSnapshot.gap_mask``): their rows are zero-filled, so to
    the clustering they look like impossibly *fast* processes.  A masked
    rank is therefore reported as ``missing`` — never as a straggler, never
    as part of the healthy majority — and the majority cluster is chosen by
    its count of *covered* ranks only."""
    ext = report.external
    gapset = {int(r) for r in gap_ranks}
    miss = tuple(sorted(gapset))
    m = len(ext.clustering.labels)
    if not ext.exists or ext.clustering.n_clusters <= 1:
        return StragglerVerdict((), tuple(r for r in range(m)
                                          if r not in gapset),
                                ext.severity, {}, "none", miss)
    clusters = ext.clustering.clusters
    covered = lambda c: tuple(r for r in c if r not in gapset)
    majority = max(clusters, key=lambda c: len(covered(c)))
    stragglers = tuple(r for c in clusters if c is not majority
                       for r in covered(c))
    causes: Dict[int, Tuple[str, ...]] = {}
    if report.external_root_causes:
        for rank, attrs in report.external_root_causes.per_entry:
            if rank in stragglers and attrs:
                causes[int(rank)] = attrs
    if not stragglers:
        action = "none"
    else:
        action = "alert" if ext.severity < SEVERITY_ALERT else "rebalance"
    return StragglerVerdict(stragglers, covered(majority), ext.severity,
                            causes, action, miss)


def detect_timeline(session_report) -> Tuple[StragglerVerdict, ...]:
    """Run straggler detection over every window of a streaming
    ``core.session.SessionReport`` — one verdict per window, oldest first.
    Windows that carry ``gap_ranks`` (merged pod views with missing hosts)
    are classified gap-aware.  Failed (tombstoned) windows carry no report
    and are skipped."""
    return tuple(detect(w.report, gap_ranks=getattr(w, "gap_ranks", ()))
                 for w in session_report.windows
                 if not getattr(w, "failed", False))


def persistent_stragglers(verdicts: Sequence[StragglerVerdict],
                          min_windows: int = 2) -> Tuple[int, ...]:
    """Ranks that straggled in at least ``min_windows`` *consecutive* windows
    — the production signal worth acting on (a single-window straggle is
    usually scheduler noise; a persistent one is a sick host)."""
    streak: Dict[int, int] = {}
    flagged = set()
    for v in verdicts:
        current = set(v.stragglers)
        for r in list(streak):
            if r not in current:
                del streak[r]
        for r in current:
            streak[r] = streak.get(r, 0) + 1
            if streak[r] >= min_windows:
                flagged.add(r)
    return tuple(sorted(flagged))


def rebalance_weights(cpu_time_per_rank: np.ndarray,
                      gap_ranks: Sequence[int] = ()) -> np.ndarray:
    """Work-redistribution weights ~ 1 / observed rate (the paper's dynamic
    dispatch: slow ranks get proportionally less of the next window's work).
    Normalized so present ranks sum to their own count.  ``gap_ranks``
    (missing hosts, zero-filled rows) get weight 0 — a host that shipped no
    data must not be handed work on the strength of a phantom zero time."""
    t = np.asarray(cpu_time_per_rank, dtype=np.float64)
    t = np.maximum(t, 1e-9)
    w = 1.0 / t
    if len(gap_ranks):
        w[np.asarray(sorted({int(r) for r in gap_ranks}), dtype=np.int64)] = 0.0
    total = w.sum()
    if total <= 0:
        raise ValueError("rebalance_weights: every rank is gap-masked")
    return w * (np.count_nonzero(w) / total)
