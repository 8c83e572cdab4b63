"""Retained reference implementations of the analysis hot-path algorithms.

These are the pre-vectorization versions of ``optics.cluster``,
``optics.reachability_order`` and the k-means 1-D DP, kept verbatim as
*oracles*: the production implementations in ``optics.py`` / ``kmeans.py``
are required to produce bit-identical results, and the property tests in
``tests/test_fastpath.py`` enforce that equivalence on random and
degenerate matrices.  (For clustering the guarantee is exact in the
single-distance-block regime, m <= ~2048 — the only scale these
Python-loop oracles can realistically be run at; larger matrices use
blocked GEMMs whose final-ulp rounding may differ.)  Never import these on
a hot path — they are O(m^2) Python-loop algorithms by design.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .optics import (COUNT_THRESHOLD, EPS_FRACTION, _ABS_EPS_FLOOR,
                     ClusterResult)
from .vectors import lengths, pairwise_distances, as_matrix


def _eps(ln: np.ndarray, i: int) -> float:
    return max(EPS_FRACTION * float(ln[i]), _ABS_EPS_FLOOR)


def cluster_reference(perf, eps_fraction: float = EPS_FRACTION,
                      count_threshold: int = COUNT_THRESHOLD) -> ClusterResult:
    """Per-point Python-queue density expansion (the original ``cluster``)."""
    perf = as_matrix(perf)
    m = perf.shape[0]
    if m == 0:
        return ClusterResult((), (), ())
    dist = pairwise_distances(perf)
    ln = lengths(perf)

    labels = np.full(m, -1, dtype=np.int64)
    next_label = 0
    for anchor in range(m):
        if labels[anchor] >= 0:
            continue
        eps = max(eps_fraction * float(ln[anchor]), _ABS_EPS_FLOOR)
        neigh = np.flatnonzero(dist[anchor] < eps)  # includes anchor itself
        if len(neigh) >= count_threshold:
            labels[anchor] = next_label
            queue: List[int] = [q for q in neigh if labels[q] < 0]
            for q in queue:
                labels[q] = next_label
            while queue:
                p = queue.pop()
                eps_p = max(eps_fraction * float(ln[p]), _ABS_EPS_FLOOR)
                n_p = np.flatnonzero(dist[p] < eps_p)
                if len(n_p) >= count_threshold:
                    for q in n_p:
                        if labels[q] < 0:
                            labels[q] = next_label
                            queue.append(int(q))
            next_label += 1
    isolated = tuple(int(i) for i in np.flatnonzero(labels < 0))
    for i in isolated:
        labels[i] = next_label
        next_label += 1
    order: dict = {}
    for i in range(m):
        order.setdefault(int(labels[i]), i)
    remap = {old: new for new, old in
             enumerate(sorted(order, key=lambda lab: order[lab]))}
    labels = np.array([remap[int(l)] for l in labels], dtype=np.int64)
    clusters: List[List[int]] = [[] for _ in range(next_label)]
    for i, lab in enumerate(labels):
        clusters[int(lab)].append(i)
    clusters_t = tuple(tuple(c) for c in clusters if c)
    return ClusterResult(tuple(int(l) for l in labels), clusters_t, isolated)


def reachability_order_reference(perf, eps_fraction: float = EPS_FRACTION,
                                 min_pts: int = COUNT_THRESHOLD + 1
                                 ) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """OPTICS ordering with the original sort-the-seed-list-per-pop loop."""
    perf = as_matrix(perf)
    m = perf.shape[0]
    dist = pairwise_distances(perf)
    ln = lengths(perf)
    processed = np.zeros(m, dtype=bool)
    reach = np.full(m, np.inf)
    order: List[int] = []

    def core_distance(p: int) -> float:
        eps = _eps(ln, p)
        within = np.sort(dist[p][dist[p] < eps])
        return float(within[min_pts - 1]) if len(within) >= min_pts else np.inf

    for start in range(m):
        if processed[start]:
            continue
        seeds = [(np.inf, start)]
        while seeds:
            seeds.sort()
            r, p = seeds.pop(0)
            if processed[p]:
                continue
            processed[p] = True
            order.append(p)
            cd = core_distance(p)
            if np.isfinite(cd):
                eps = _eps(ln, p)
                for q in np.flatnonzero(dist[p] < eps):
                    if processed[q]:
                        continue
                    newr = max(cd, float(dist[p, q]))
                    if newr < reach[q]:
                        reach[q] = newr
                        seeds.append((newr, int(q)))
    return tuple(order), tuple(float(reach[i]) for i in order)


def optimal_1d_partition_reference(sorted_vals: np.ndarray,
                                   k: int) -> np.ndarray:
    """Exact 1-D k-means DP with the original O(n^2 k) per-row argmin."""
    n = len(sorted_vals)
    pre = np.concatenate([[0.0], np.cumsum(sorted_vals)])
    pre2 = np.concatenate([[0.0], np.cumsum(sorted_vals ** 2)])

    INF = float("inf")
    D = np.full((k + 1, n + 1), INF)
    D[0, 0] = 0.0
    arg = np.zeros((k + 1, n + 1), dtype=np.int64)
    for m in range(1, k + 1):
        for i in range(m, n + 1):
            # candidates j in [m-1, i): cluster m covers sorted[j..i-1]
            j = np.arange(m - 1, i)
            cnt = i - j
            s = pre[i] - pre[j]
            sse = pre2[i] - pre2[j] - s * s / cnt
            cost = D[m - 1, j] + sse
            bj = int(np.argmin(cost))
            D[m, i] = cost[bj]
            arg[m, i] = j[bj]
    labels = np.zeros(n, dtype=np.int64)
    i = n
    for m in range(k, 0, -1):
        j = arg[m, i]
        labels[j:i] = m - 1
        i = j
    return labels


def analyze_external_reference(tree, perf):
    """The full §3.2 CCR/CCCR search driven end-to-end by the retained
    Python-queue clustering — the oracle the collapse-certificate property
    tests compare the quantized fast path against (small m only)."""
    from .external import ExternalAnalyzer   # lazy: avoid an import cycle
    return ExternalAnalyzer(tree, perf, cluster_fn=cluster_reference).analyze()


def extract_core_reference(table):
    """The original §3.4.1 Steps 1-3 driven by the full discernibility
    matrix (O(entries^2) Python pairs) — the oracle the weighted-group
    clause sweep in ``roughset.extract_core`` is property-tested against."""
    import itertools
    from .roughset import (CoreResult, INDISCERNIBLE, SAME_DECISION, _absorb,
                           discernibility_matrix)
    mat = discernibility_matrix(table)
    n = len(table.entry_ids)
    clauses = []
    inconsistent = 0
    for i in range(n):
        for j in range(i + 1, n):
            c = mat[i][j]
            if c == SAME_DECISION:
                continue
            if c == INDISCERNIBLE:
                inconsistent += 1
                continue
            clauses.append(c)
    if not clauses:
        return CoreResult((), ((),) if not inconsistent else (), inconsistent)
    cs = sorted({next(iter(c)) for c in clauses if len(c) == 1})
    cs_set = set(cs)
    remaining = _absorb([c for c in clauses if not (c & cs_set)])
    if not remaining:
        return CoreResult(tuple(cs), (tuple(cs),), inconsistent)
    counts = {}
    for combo in itertools.product(*[sorted(c) for c in remaining]):
        key = frozenset(combo)
        counts[key] = counts.get(key, 0) + 1
    min_size = min(len(k) for k in counts)
    at_min = {k: v for k, v in counts.items() if len(k) == min_size}
    max_count = max(at_min.values())
    winners = sorted((tuple(sorted(cs_set | k)) for k, v in at_min.items()
                      if v == max_count))
    return CoreResult(tuple(cs), tuple(winners), inconsistent)
