"""Internal-bottleneck detection (paper §3.3).

Internal bottlenecks live inside a process (poor locality, poor I/O,
inefficient algorithm).  The paper's single normalized metric per region is

    CRNM = (CRWT / WPWT) * CPI            (Eq. 4)

where CRWT = region wall time, WPWT = whole-program wall time and CPI =
cycles per instruction for the region.  Regions are k-means-classified into
five severity classes; classes {high, very high} are CCRs, refined to CCCRs
over the region tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .kmeans import KMeansResult, SEVERITY_NAMES, severity_classes
from .regions import RegionTree
from .vectors import as_matrix

CCR_MIN_SEVERITY = 3  # 'high'


def crnm(wall: np.ndarray, program_wall: np.ndarray,
         cycles: np.ndarray, instructions: np.ndarray) -> np.ndarray:
    """Per-process, per-region CRNM matrix (Eq. 4).

    wall, cycles, instructions: (m, n); program_wall: (m,).
    Regions off a process's call path (zero wall time) score 0, as the paper
    requires for SPMD programs containing 'if' statements.
    """
    wall = as_matrix(wall)
    cycles = as_matrix(cycles)
    instructions = as_matrix(instructions)
    pw = np.asarray(program_wall, dtype=np.float64).reshape(-1, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cpi = np.where(instructions > 0, cycles / np.maximum(instructions, 1e-30), 0.0)
        share = np.where(pw > 0, wall / np.maximum(pw, 1e-30), 0.0)
    return share * cpi


@dataclasses.dataclass(frozen=True)
class InternalReport:
    crnm_mean: Tuple[float, ...]            # average CRNM per region (tree id order)
    severity: KMeansResult                  # 5-class k-means result
    ccrs: Tuple[int, ...]                   # region ids with severity >= high
    cccrs: Tuple[int, ...]                  # internal bottlenecks
    region_ids: Tuple[int, ...]

    def severity_of(self, rid: int) -> int:
        try:
            i = self.region_ids.index(rid)
        except ValueError:
            # unknown region: same LookupError family as the gated-window
            # case below, never a bare list.index ValueError
            raise LookupError(
                f"region {rid} is not in this report's region tree "
                f"(known ids: {list(self.region_ids)})") from None
        if i >= len(self.severity.labels):
            # gated windows (AnalysisSession internal_gate_s) carry an empty
            # severity stub — no region was classified
            raise LookupError(
                f"region {rid} has no severity class: the internal pass was "
                f"skipped for this window (external gate)")
        return self.severity.labels[i]

    def render(self, tree: Optional[RegionTree] = None) -> str:
        nm = (lambda r: tree.name(r)) if tree is not None else (lambda r: str(r))
        lines = []
        for sev in range(len(SEVERITY_NAMES) - 1, -1, -1):
            members = [self.region_ids[i] for i in self.severity.members(sev)]
            if members:
                lines.append(f"{SEVERITY_NAMES[sev]}: " + ", ".join(nm(r) for r in members))
        lines.append("internal CCCRs: " + (", ".join(nm(r) for r in self.cccrs) or "(none)"))
        return "\n".join(lines)


def analyze_internal(tree: RegionTree,
                     crnm_matrix: np.ndarray) -> InternalReport:
    """Average CRNM over processes, classify severity, search CCCRs."""
    cm = as_matrix(crnm_matrix)
    region_ids = tree.ids()
    if cm.shape[1] != len(region_ids):
        raise ValueError("CRNM matrix width != number of regions")
    mean = np.mean(cm, axis=0)
    km = severity_classes(mean)
    sev: Dict[int, int] = {rid: km.labels[i] for i, rid in enumerate(region_ids)}
    ccrs = tuple(rid for rid in region_ids if sev[rid] >= CCR_MIN_SEVERITY)

    cccrs = []
    for rid in ccrs:
        if tree.is_leaf(rid):
            cccrs.append(rid)            # rule (1)
        else:
            kids = tree.children(rid)
            if all(sev[k] < sev[rid] for k in kids):
                cccrs.append(rid)        # rule (2)
    return InternalReport(tuple(float(x) for x in mean), km, ccrs,
                          tuple(cccrs), region_ids)


def attribute_flags(values_per_region: np.ndarray) -> np.ndarray:
    """Discretize per-region attribute averages for the rough-set table
    (paper §3.4.3): 1 iff k-means severity is above 'medium'."""
    vals = np.asarray(values_per_region, dtype=np.float64)
    km = severity_classes(vals)
    return (np.asarray(km.labels, dtype=np.int64) > 2).astype(np.int64)
