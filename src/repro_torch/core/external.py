"""External-bottleneck detection and location (paper §3.2).

External bottlenecks live in the *interaction* between processes (load
imbalance, contention).  Detection: cluster the per-process vectors of
per-region CPU time; more than one cluster => external bottlenecks exist.
Location: the paper's top-down zero-out-and-recluster search over the code
region tree (Steps 1-5), refining Critical Code Regions (CCR) to Cores of
Critical Code Regions (CCCR).

Convention: ``perf`` is the m x n matrix of *inclusive* CPU time (region time
includes nested children).  Inclusive times are required for Step 2 to see a
nested bottleneck through its depth-1 ancestor (the paper's ST case: the
depth-2 ``region 11`` signal is found via depth-1 ``region 14`` first).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .optics import (EPS_FRACTION, _ABS_EPS_FLOOR, ClusterResult, cluster,
                     cluster_eps, cluster_labels, labels_to_result,
                     reachability_graph, robust_reachability_graph)
from .regions import RegionTree
from .vectors import (as_matrix, ball_group_rows, iter_sqdistance_blocks,
                      keep_columns, severity_S)

MAX_COMPOSITE_COMBOS = 4096  # safety cap for Step 5 enumeration

# The search fast path keeps three r x r float64 buffers (the squared
# distances, a per-column difference scratch, and the downdate target) alive
# across its O(regions) re-clusterings; above this budget it falls back to
# per-call blocked GEMMs (plain `cluster`), trading speed for the row-wise
# memory bound.
FAST_PATH_MAX_BYTES = 512 * 2 ** 20

# -- collapse modes ----------------------------------------------------------
COLLAPSE_EXACT = "exact"          # bit-identical duplicate rows only
COLLAPSE_QUANTIZED = "quantized"  # eps-margin balls + exactness certificate
COLLAPSE_AUTO = "auto"            # quantized at pod scale, exact below
COLLAPSE_MODES = (COLLAPSE_AUTO, COLLAPSE_EXACT, COLLAPSE_QUANTIZED)

#: ``auto`` engages the certified ball collapse only at this many ranks and
#: above; below it the exact duplicate collapse is already fast and keeps
#: reports bit-identical to the strict path.
AUTO_COLLAPSE_MIN_RANKS = 512

#: Ball radius for the quantized collapse, as a fraction of the smallest
#: positive-norm row's eps (= EPS_FRACTION * norm).  0.25 leaves the
#: certificate margin 1.1*delta_g + delta_h well under typical |d - eps|
#: gaps while still absorbing per-rank jitter orders of magnitude smaller
#: than the data.
QUANT_RADIUS_FRACTION = 0.25

#: Relative slack added to certificate margins to cover float evaluation of
#: the margins themselves and the ulp-level wobble of downdated distances
#: (both are dwarfed by any nonzero delta, but the certificate must never
#: claim robustness it does not have).
_CERT_SLACK = 1e-9


@dataclasses.dataclass(frozen=True)
class CollapseCertificate:
    """Per-window exactness certificate of the rank-collapse fast path.

    ``mode == "exact"`` means every re-clustering ran on bit-identical
    duplicate groups (or the plain path): the report is bit-identical to
    the uncollapsed search.  ``mode == "quantized"`` means rank rows were
    collapsed into balls of measured radius ``delta_max``; every
    re-clustering either passed the robust eps-margin check
    (``collapsed_calls``) — whose acceptance *proves* the member-level
    labels equal the exact ones — or automatically fell back to an exact
    path (``exact_calls``).  Either way CCRs/CCCRs/cluster labels are the
    exact search's; the reported severity is a lower bound whose distance
    from the exact value is at most ``severity_bound``.
    """
    mode: str                 # "exact" | "quantized"
    ranks: int                # m, rows of the perf matrix
    distinct_rows: int        # groups after bit-identical collapse
    groups: int               # groups the searches ran over
    delta_max: float          # largest ball radius (0.0 in exact mode)
    severity_bound: float     # |S_reported - S_exact| <= severity_bound
    collapsed_calls: int      # re-clusterings served by certified balls
    exact_calls: int          # re-clusterings that took an exact path


def _group_identical_rows(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Group bit-identical rows of ``X``: returns ``(gid, reps)`` where
    ``gid[i]`` is row i's dense group id and ``reps[g]`` the row index of
    group g's representative (its smallest member).  Group ids are ordered
    by representative index — the visit order a sequential expansion over
    the original rows would see."""
    m = X.shape[0]
    sort = np.lexsort(X.T[::-1])
    Xs = X[sort]
    boundary = np.empty(m, dtype=bool)
    boundary[0] = True
    np.any(Xs[1:] != Xs[:-1], axis=1, out=boundary[1:])
    gid_sorted = np.cumsum(boundary) - 1
    gid = np.empty(m, dtype=np.int64)
    gid[sort] = gid_sorted
    r = int(gid_sorted[-1]) + 1
    first = np.full(r, m, dtype=np.int64)
    np.minimum.at(first, gid, np.arange(m))
    relabel = np.empty(r, dtype=np.int64)
    relabel[np.argsort(first, kind="stable")] = np.arange(r)
    return relabel[gid], np.sort(first)


def cluster_collapsed(X, *, collapse: str = COLLAPSE_AUTO
                      ) -> Tuple[ClusterResult, Optional[CollapseCertificate]]:
    """One-shot collapse-accelerated clustering of an arbitrary matrix —
    the per-attribute root-cause path (``analyzer.external_root_causes``),
    under the same contract as the CCR search's rank collapse:

    * bit-identical duplicate rows always collapse to one weighted point
      (identical rows have identical neighbourhoods, so the weighted
      closure's labels equal the uncollapsed ones);
    * under ``"quantized"`` (or ``"auto"`` at >= AUTO_COLLAPSE_MIN_RANKS
      rows) the distinct rows additionally ball-group, and the single
      clustering call must pass the eps-margin exactness certificate
      (:func:`~repro.core.optics.robust_reachability_graph`) — accepted
      means the labels *provably* equal the exact ones, rejected falls
      back to the exact duplicate level automatically.

    Returns ``(result, certificate)``; the certificate is ``None`` only
    for empty input.  ``severity_bound`` is always 0.0 here: labels are
    exact under both outcomes and no severity is derived from this path.
    """
    if collapse not in COLLAPSE_MODES:
        raise ValueError(f"collapse must be one of {COLLAPSE_MODES}, "
                         f"got {collapse!r}")
    X = as_matrix(X)
    m = X.shape[0]
    if m == 0:
        return cluster(X), None
    gid, reps = _group_identical_rows(X)
    Xe = X[reps]
    r = Xe.shape[0]
    w = np.bincount(gid).astype(np.float64)
    ln_e = np.sqrt(np.sum(Xe * Xe, axis=1))
    quantized = (collapse == COLLAPSE_QUANTIZED
                 or (collapse == COLLAPSE_AUTO
                     and m >= AUTO_COLLAPSE_MIN_RANKS))

    def cert(mode, groups, delta_max, collapsed, exact):
        return CollapseCertificate(
            mode=mode, ranks=m, distinct_rows=r, groups=groups,
            delta_max=delta_max, severity_bound=0.0,
            collapsed_calls=collapsed, exact_calls=exact)

    if quantized and r > 1:
        pos = ln_e[ln_e > 0.0]
        if pos.size:
            radius = QUANT_RADIUS_FRACTION * max(
                EPS_FRACTION * float(np.min(pos)), _ABS_EPS_FLOOR)
            grouped = ball_group_rows(
                Xe, radius, max_groups=min(max(64, r // 8), 4096))
            if grouped is not None:
                qgid, leaders, delta = grouped
                r_q = len(leaders)
                if r_q < r and 8 * r_q * r_q <= FAST_PATH_MAX_BYTES:
                    L = Xe[leaders]
                    d2 = np.empty((r_q, r_q))
                    for start, stop, blk in iter_sqdistance_blocks(L):
                        d2[start:stop] = blk
                    eps_q = cluster_eps(np.sqrt(np.sum(L * L, axis=1)))
                    margin = (1.1 * delta[:, None] + delta[None, :]) \
                        * (1.0 + _CERT_SLACK)
                    reach = robust_reachability_graph(d2, eps_q, margin)
                    if reach is not None:
                        glabels = cluster_labels(
                            reach, weights=np.bincount(qgid, weights=w))
                        return (labels_to_result(glabels[qgid[gid]]),
                                cert(COLLAPSE_QUANTIZED, r_q,
                                     float(np.max(delta)), 1, 0))
    exact_calls = 1
    if 8 * r * r > FAST_PATH_MAX_BYTES:
        # too many distinct rows for the weighted graph: plain path (still
        # exact — blocked reachability over the full matrix)
        return cluster(X), cert(COLLAPSE_EXACT, m, 0.0, 0, exact_calls)
    eps = cluster_eps(ln_e)
    reach = reachability_graph(iter_sqdistance_blocks(Xe), eps, exact=True)
    glabels = cluster_labels(reach, weights=w)
    # mode reflects the level that actually produced the labels: a rejected
    # or ineffective ball grouping lands here and reports "exact"
    return (labels_to_result(glabels[gid]),
            cert(COLLAPSE_EXACT, r, 0.0, 0, exact_calls))


@dataclasses.dataclass(frozen=True)
class CCRNode:
    rid: int
    depth: int
    is_cccr: bool
    via_composite: Optional[Tuple[int, ...]] = None  # Step-5 composite members


@dataclasses.dataclass(frozen=True)
class ExternalReport:
    exists: bool
    severity: float                      # paper's S metric
    clustering: ClusterResult
    ccrs: Tuple[CCRNode, ...]            # all CCRs found, top-down order
    cccrs: Tuple[int, ...]               # region ids that are external bottlenecks
    certificate: Optional[CollapseCertificate] = None

    def render(self, tree: Optional[RegionTree] = None) -> str:
        nm = (lambda r: tree.name(r)) if tree is not None else (lambda r: f"region {r}")
        lines = ["Performance similarity", self.clustering.render("kind"),
                 f"dissimilarity severity, S: {self.severity:.6f}"]
        if not self.exists:
            lines.append("no external bottleneck")
            return "\n".join(lines)
        lines.append("CCCR: " + (", ".join(nm(r) for r in self.cccrs) or "(none)"))
        chains: List[str] = []
        for node in self.ccrs:
            tag = f"{node.depth}-CCR" + (" & CCCR" if node.is_cccr else "")
            chains.append(f"{nm(node.rid)} ({tag})")
        if chains:
            lines.append("CCR tree: " + " ---> ".join(chains))
        return "\n".join(lines)


class _SearchBuffers:
    """Weighted-group re-clustering buffers: the r x r squared-distance
    matrix of group representatives, materialized once and downdated per
    call with the dropped columns' squared differences.

    ``delta is None`` is the exact level (bit-identical duplicate groups:
    identical neighbourhoods under every column subset, labels bit-identical
    to the uncollapsed clustering).  With ``delta`` set, each group is a
    ball of that measured radius around its representative (an actual data
    row) and every call must pass the eps-margin certificate
    (:func:`~repro.core.optics.robust_reachability_graph`) — radii over the
    *full* columns upper-bound radii under every column subset (a subset
    Euclidean norm never exceeds the full one), so one delta per group
    certifies every downdated call — or ``cluster_live`` returns ``None``
    and the caller falls back to an exact path.

    Downdate scratch is thread-local so independent region-columns of the
    search can share one instance read-only.
    """

    def __init__(self, X: np.ndarray, weights: np.ndarray, gid: np.ndarray,
                 delta: Optional[np.ndarray]):
        self.X = X
        self.weights = weights
        self.gid = gid
        self.delta = delta
        self.r = X.shape[0]
        self.colsq = X * X
        self.sq_full = np.sum(self.colsq, axis=1)
        self.d2_full = np.empty((self.r, self.r))
        for start, stop, blk in iter_sqdistance_blocks(X):
            self.d2_full[start:stop] = blk
        if delta is not None:
            self.margin = (1.1 * delta[:, None] + delta[None, :]) \
                * (1.0 + _CERT_SLACK)
        self._tls = threading.local()

    def _scratch(self) -> Tuple[np.ndarray, np.ndarray]:
        tls = self._tls
        if getattr(tls, "diff", None) is None:
            tls.diff = np.empty((self.r, self.r))
            tls.work = np.empty((self.r, self.r))
        return tls.diff, tls.work

    def _live_matrices(self, keep: Sequence[int],
                       n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Squared distances + squared norms with only ``keep`` columns
        contributing (same floats as the pre-collapse implementation)."""
        dropped = [c for c in range(n) if c not in set(keep)]
        d2 = sq = None
        if not dropped:
            d2, sq = self.d2_full, self.sq_full
        elif len(dropped) <= len(keep):
            # downdate: subtract each dropped column's squared differences
            diff, work = self._scratch()
            d2, sq = work, self.sq_full.copy()
            for pos, c in enumerate(dropped):
                col = self.X[:, c]
                np.subtract(col[:, None], col[None, :], out=diff)
                np.square(diff, out=diff)
                if pos == 0:
                    np.subtract(self.d2_full, diff, out=d2)
                else:
                    d2 -= diff
                sq -= self.colsq[:, c]
            # cancellation can leave tiny negatives; and when a row's kept
            # mass is vanishingly small next to what was subtracted, the
            # leftover junk can exceed that row's eps^2 entirely — rebuild
            # those (rare) calls exactly instead
            np.maximum(sq, 0.0, out=sq)
            if bool(np.any(sq * 1e11 < self.sq_full)):
                d2 = sq = None
        if d2 is None:
            # few live columns, or a downdate too cancellation-prone:
            # rebuild from scratch (still at group level)
            live = keep_columns(self.X, sorted(keep))
            _, d2 = self._scratch()
            for start, stop, blk in iter_sqdistance_blocks(live):
                d2[start:stop] = blk
            sq = np.sum(live * live, axis=1)
        return d2, sq

    def cluster_live(self, keep: Sequence[int],
                     n: int) -> Optional[ClusterResult]:
        """Cluster with only ``keep`` columns contributing; ``None`` when
        the exactness certificate rejects this call (quantized level only)."""
        d2, sq = self._live_matrices(keep, n)
        eps = cluster_eps(np.sqrt(sq))
        if self.delta is None:
            reach = reachability_graph([(0, self.r, d2)], eps, exact=False)
        else:
            reach = robust_reachability_graph(d2, eps, self.margin)
            if reach is None:
                return None
        glabels = cluster_labels(reach, weights=self.weights)
        return labels_to_result(glabels[self.gid])


class ExternalAnalyzer:
    """Runs the paper's §3.2 algorithm against a RegionTree + perf matrix.

    The top-down CCR search re-clusters the same m processes O(regions)
    times, each time with a different set of region columns zeroed out.
    The default-``cluster`` path exploits structural facts instead of
    paying a fresh m x m GEMM per re-clustering:

    * SPMD pod snapshots carry many bit-identical rows (equal shards,
      simulated ranks, gap-filled hosts).  Identical rows have identical
      neighbourhoods under every column subset, so they are collapsed to
      one weighted point each; clustering runs over the r distinct rows
      (``cluster_labels(weights=...)``) and labels are expanded back to
      ranks.
    * At pod scale rows are rarely bit-identical but often *near*-identical
      (per-rank jitter on an SPMD workload).  ``collapse`` extends the
      duplicate collapse to eps-margin balls: distinct rows within
      ``QUANT_RADIUS_FRACTION`` of the smallest eps of their leader row are
      collapsed to one weighted representative, and every re-clustering is
      guarded by an exactness certificate — accepted calls are *provably*
      label-identical to the exact search, rejected calls fall back to the
      exact path automatically (see :class:`CollapseCertificate`).
    * Zeroing columns only *removes* additive ``(x_i - x_j)^2`` terms from
      every squared distance, so the full squared-distance matrix is
      materialized once and *downdated* per call with the dropped columns'
      per-column squared differences.

    ``column_workers > 1`` shards the independent region-columns of each
    search step (Step 2's drop-one tests, Steps 3-4's child substitutions)
    across a thread executor; the workers share the read-only distance
    buffers and use thread-local downdate scratch, and results are
    collected in submission order, so the report is identical to the
    serial search.

    A custom ``cluster_fn`` — or a matrix whose buffers would exceed
    ``FAST_PATH_MAX_BYTES`` — uses the plain per-call path.  The fast path
    can differ from per-call blocked GEMMs in the last ulp of a distance
    (different accumulation orders), far below the 10%-of-norm eps margins;
    the strict bit-identical contract lives on ``cluster`` itself.
    """

    def __init__(self, tree: RegionTree, perf_inclusive,
                 cluster_fn: Callable[[np.ndarray], ClusterResult] = cluster,
                 *, collapse: str = COLLAPSE_AUTO, column_workers: int = 1):
        if collapse not in COLLAPSE_MODES:
            raise ValueError(f"collapse must be one of {COLLAPSE_MODES}, "
                             f"got {collapse!r}")
        if column_workers < 1:
            raise ValueError("column_workers must be >= 1")
        self.tree = tree
        self.perf = as_matrix(perf_inclusive)
        if self.perf.shape[1] != len(tree):
            raise ValueError(
                f"perf has {self.perf.shape[1]} columns but tree has {len(tree)} regions")
        self.cluster_fn = cluster_fn
        self.collapse = collapse
        self.column_workers = column_workers
        self._col: Dict[int, int] = {rid: c for c, rid in enumerate(tree.ids())}
        m, n = self.perf.shape
        self._fast = cluster_fn is cluster and n >= 1
        self._prepared = False
        self._gid_e: Optional[np.ndarray] = None   # rank -> distinct row
        self._w_e: Optional[np.ndarray] = None     # distinct-row weights
        self._X_e: Optional[np.ndarray] = None     # (r_e, n) distinct rows
        self._ln_e: Optional[np.ndarray] = None    # exact distinct-row norms
        self._qbuf: Optional[_SearchBuffers] = None   # certified ball level
        self._ebuf: Optional[_SearchBuffers] = None   # exact dup level (lazy)
        self._ebuf_over_budget = False
        self._lock = threading.Lock()
        self._collapsed_calls = 0
        self._exact_calls = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- column helpers ----------------------------------------------------
    def _cols(self, rids: Sequence[int]) -> List[int]:
        return [self._col[r] for r in rids]

    def _vectors(self, live_rids: Sequence[int]) -> np.ndarray:
        return keep_columns(self.perf, self._cols(live_rids))

    def _active(self, rid: int) -> bool:
        """Paper Step 2 guard: only regions with some nonzero time count."""
        return bool(np.any(self.perf[:, self._col[rid]] > 0))

    # -- clustering fast path ----------------------------------------------
    def _quantized_requested(self) -> bool:
        return (self.collapse == COLLAPSE_QUANTIZED
                or (self.collapse == COLLAPSE_AUTO
                    and self.perf.shape[0] >= AUTO_COLLAPSE_MIN_RANKS))

    def _ensure_prepared(self) -> bool:
        """Collapse bit-identical rows (always cheap) and, when the mode
        asks for it, ball-group the distinct rows; returns False when there
        is nothing to run the group-level search on."""
        if self._prepared:
            return self._gid_e is not None
        self._prepared = True
        X = self.perf
        m = X.shape[0]
        if m == 0:
            self._fast = False
            return False
        # group bit-identical rows; representative = smallest member rank
        self._gid_e, reps = _group_identical_rows(X)
        r = len(reps)
        self._w_e = np.bincount(self._gid_e).astype(np.float64)
        self._X_e = X[reps]                 # (r_e, n) distinct rows
        self._ln_e = np.sqrt(np.sum(self._X_e * self._X_e, axis=1))
        if self._quantized_requested() and r > 1:
            self._build_quantized(r)
        return True

    def _build_quantized(self, r_e: int) -> None:
        """Ball-group the distinct rows; keeps ``_qbuf`` unset when the
        grouping would not pay for itself (no reduction, radius degenerate,
        too many balls, or buffers over budget) — callers then use the
        exact level, so an ineffective grouping costs only its one sweep."""
        pos = self._ln_e[self._ln_e > 0.0]
        if not pos.size:
            return                 # all-zero rows are bit-identical anyway
        radius = QUANT_RADIUS_FRACTION * max(
            EPS_FRACTION * float(np.min(pos)), _ABS_EPS_FLOOR)
        max_groups = min(max(64, r_e // 8), 4096)
        grouped = ball_group_rows(self._X_e, radius, max_groups=max_groups)
        if grouped is None:
            return
        qgid_e, leaders, delta = grouped
        r_q = len(leaders)
        if r_q >= r_e or 3 * 8 * r_q * r_q > FAST_PATH_MAX_BYTES:
            return
        self._qbuf = _SearchBuffers(self._X_e[leaders],
                                    np.bincount(qgid_e,
                                                weights=self._w_e),
                                    qgid_e[self._gid_e], delta)

    def _exact_buffers(self) -> Optional[_SearchBuffers]:
        """The exact duplicate-collapse level, built lazily (under the
        quantized mode it only materializes on the first certificate
        rejection) and subject to the memory budget."""
        if self._ebuf is None and not self._ebuf_over_budget:
            with self._lock:
                if self._ebuf is None and not self._ebuf_over_budget:
                    r = self._X_e.shape[0]
                    if 3 * 8 * r * r > FAST_PATH_MAX_BYTES:
                        self._ebuf_over_budget = True
                    else:
                        self._ebuf = _SearchBuffers(
                            self._X_e, self._w_e, self._gid_e, None)
        return self._ebuf

    def _count(self, collapsed: bool) -> None:
        with self._lock:
            if collapsed:
                self._collapsed_calls += 1
            else:
                self._exact_calls += 1

    def _cluster_live(self, live_rids: Sequence[int]) -> ClusterResult:
        """Cluster with only ``live_rids``'s columns contributing."""
        if not self._fast or not self._ensure_prepared():
            return self.cluster_fn(self._vectors(live_rids))
        n = self.perf.shape[1]
        keep = sorted(self._cols(live_rids))
        if self._qbuf is not None:
            res = self._qbuf.cluster_live(keep, n)
            if res is not None:
                self._count(collapsed=True)
                return res
        self._count(collapsed=False)
        ebuf = self._exact_buffers()
        if ebuf is not None:
            return ebuf.cluster_live(keep, n)
        return self.cluster_fn(self._vectors(live_rids))

    def _map_cluster(self, rid_lists: Sequence[Sequence[int]]
                     ) -> List[ClusterResult]:
        """``_cluster_live`` over independent column sets — the unit the
        column executor shards; results keep submission order."""
        if self._pool is None or len(rid_lists) <= 1:
            return [self._cluster_live(rl) for rl in rid_lists]
        return list(self._pool.map(self._cluster_live, rid_lists))

    def _severity_and_bound(self) -> Tuple[float, float]:
        """Paper Eq. 2 from the group-level buffers when available.  Under
        the quantized collapse the max pairwise distance is only known to
        ball resolution: representatives are actual rows, so the group max
        is a true lower bound, and inflating every pair by its radii bounds
        the true max from above; the min norm is exact either way (taken
        over the distinct rows, O(m n) total)."""
        m = self.perf.shape[0]
        if m < 2:
            return 0.0, 0.0
        if not self._fast or not self._ensure_prepared():
            return severity_S(self.perf), 0.0
        if self._qbuf is not None:
            q = self._qbuf
            dmat = np.sqrt(np.maximum(q.d2_full, 0.0))
            max_dist = float(np.max(dmat))
            upper = float(np.max(dmat + q.delta[:, None] + q.delta[None, :]))
            min_len = float(np.min(self._ln_e))
            if min_len <= 0.0:
                min_len = float(np.dot(self._w_e, self._ln_e) / m) or 1.0
            return max_dist / min_len, (upper - max_dist) / min_len
        ebuf = self._exact_buffers()
        if ebuf is None:
            return severity_S(self.perf), 0.0
        max_dist = float(np.sqrt(max(0.0, float(np.max(ebuf.d2_full)))))
        ln = np.sqrt(ebuf.sq_full)
        min_len = float(np.min(ln))
        if min_len <= 0.0:
            min_len = float(np.dot(ebuf.weights, ln) / m) or 1.0
        return max_dist / min_len, 0.0

    def _certificate(self, severity_bound: float
                     ) -> Optional[CollapseCertificate]:
        if not self._fast or self._gid_e is None:
            return None
        r_e = int(self._X_e.shape[0])
        if self._qbuf is not None:
            return CollapseCertificate(
                mode=COLLAPSE_QUANTIZED, ranks=int(self.perf.shape[0]),
                distinct_rows=r_e, groups=int(self._qbuf.r),
                delta_max=float(np.max(self._qbuf.delta)),
                severity_bound=severity_bound,
                collapsed_calls=self._collapsed_calls,
                exact_calls=self._exact_calls)
        return CollapseCertificate(
            mode=COLLAPSE_EXACT, ranks=int(self.perf.shape[0]),
            distinct_rows=r_e, groups=r_e, delta_max=0.0,
            severity_bound=0.0, collapsed_calls=0,
            exact_calls=self._exact_calls)

    # -- main entry ---------------------------------------------------------
    def analyze(self) -> ExternalReport:
        base = self._cluster_live(list(self._col))
        S, S_bound = self._severity_and_bound()
        if base.n_clusters <= 1:
            return ExternalReport(False, S, base, (), (),
                                  self._certificate(S_bound))

        ccrs: List[CCRNode] = []
        cccrs: List[int] = []

        if self.column_workers > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=self.column_workers,
                thread_name_prefix="perfdbg-column")
        try:
            level1 = [r for r in self.tree.at_depth(1) if self._active(r)]
            ref = self._cluster_live(level1)
            one_ccrs = self._find_level1_ccrs(level1, ref)

            if one_ccrs:
                for rid in one_ccrs:
                    ccrs.append(CCRNode(rid, 1, False))
                    context = [r for r in level1 if r != rid]
                    self._descend(rid, context, ref, ccrs, cccrs)
            else:
                # Step 5: composite depth-1 regions
                self._composite_search(level1, ccrs, cccrs)
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

        # mark CCCR flags on the CCR list
        marked = tuple(
            dataclasses.replace(node, is_cccr=node.rid in cccrs) for node in ccrs)
        return ExternalReport(True, S, base, marked, tuple(dict.fromkeys(cccrs)),
                              self._certificate(S_bound))

    # -- Step 2 -------------------------------------------------------------
    def _find_level1_ccrs(self, level1: Sequence[int],
                          ref: ClusterResult) -> List[int]:
        tests = self._map_cluster(
            [[r for r in level1 if r != rid] for rid in level1])
        return [rid for rid, test in zip(level1, tests)
                if not test.same_output(ref)]

    # -- Steps 3-4 ------------------------------------------------------------
    def _descend(self, p: int, context: Sequence[int], ref: ClusterResult,
                 ccrs: List[CCRNode], cccrs: List[int],
                 composite: Optional[Tuple[int, ...]] = None) -> None:
        """Refine CCR ``p``: test each child in place of p's column; a child
        that alone reproduces the reference clustering is an L-CCR."""
        children = [k for k in self.tree.children(p) if self._active(k)]
        if not children:
            cccrs.append(p)
            return
        tests = self._map_cluster(
            [list(context) + [k] for k in children])
        child_ccrs = [k for k, test in zip(children, tests)
                      if test.same_output(ref)]
        if not child_ccrs:
            cccrs.append(p)
            return
        for k in child_ccrs:
            ccrs.append(CCRNode(k, self.tree.depth(k), False, composite))
            self._descend(k, context, ref, ccrs, cccrs, composite)

    # -- Step 5 ---------------------------------------------------------------
    def _composite_search(self, level1: Sequence[int],
                          ccrs: List[CCRNode], cccrs: List[int]) -> None:
        r = len(level1)
        for s in range(2, max(r, 2)):
            combos = list(itertools.combinations(level1, s))
            if len(combos) > MAX_COMPOSITE_COMBOS:  # pragma: no cover - safety
                combos = combos[:MAX_COMPOSITE_COMBOS]
            # composite vectors: each combo contributes the union of its
            # member columns; remaining singles stay as-is.
            ref = self._cluster_live(list(level1))
            for combo in combos:
                singles = [x for x in level1 if x not in combo]
                # drop the whole composite: changed output => composite is 1-CCR
                test = self._cluster_live(singles)
                if test.same_output(ref):
                    continue
                # composite region found; descend into each member as a child
                member_tests = self._map_cluster(
                    [singles + [k] for k in combo])
                member_ccrs = [k for k, t2 in zip(combo, member_tests)
                               if t2.same_output(ref)]
                if not member_ccrs:
                    # the combination only acts jointly: every member is a CCCR
                    for k in combo:
                        ccrs.append(CCRNode(k, self.tree.depth(k), False, combo))
                        cccrs.append(k)
                    return
                for k in member_ccrs:
                    ccrs.append(CCRNode(k, self.tree.depth(k), False, combo))
                    context = singles
                    self._descend(k, context, ref, ccrs, cccrs, combo)
                return
        # nothing found even with composites: report the whole level as CCCRs
        for k in level1:  # pragma: no cover - pathological
            cccrs.append(k)


def analyze_external(tree: RegionTree, perf_inclusive,
                     cluster_fn: Callable[[np.ndarray], ClusterResult] = cluster,
                     *, collapse: str = COLLAPSE_AUTO,
                     column_workers: int = 1) -> ExternalReport:
    return ExternalAnalyzer(tree, perf_inclusive, cluster_fn,
                            collapse=collapse,
                            column_workers=column_workers).analyze()
