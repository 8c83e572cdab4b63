"""Density clustering of process performance vectors (paper §3.2.1, Fig. 2).

The paper uses an OPTICS-flavoured density clustering whose two parameters are
fixed by the text:

  * neighbourhood threshold  eps_p = 10% * len(V_p)   (relative to the anchor)
  * count_threshold          = 2    (a cluster needs > 2 points in reach)

Points not absorbed into any cluster are *isolated points*; each isolated
point forms its own singleton cluster.  OPTICS is chosen "because it has
advantage in discovering isolated points".

We implement the paper's greedy procedure with density expansion (the OPTICS/
DBSCAN reachability closure) and make it fully deterministic: anchors are
visited in rank order and cluster ids are assigned by smallest member rank.

The implementation is fully vectorized: the boolean eps-reachability graph is
built from row blocks of the distance matrix (bounded memory, see
``vectors.iter_distance_blocks``) and the reachability closure is taken by
numpy min-label propagation over core points instead of a per-point Python
queue.  The result is bit-identical to the retained reference implementation
(``core._reference.cluster_reference``), enforced by property tests; the
equivalence argument is spelled out inside :func:`cluster`.

``reachability_order`` additionally exposes the classic OPTICS ordering +
reachability distances for diagnostics (not needed by the search algorithms).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .vectors import (as_matrix, iter_sqdistance_blocks, lengths,
                      pairwise_distances, canonical_partition)

EPS_FRACTION = 0.10      # paper: threshold = 10% * len(V_p)
COUNT_THRESHOLD = 2      # paper: count_threshold = 2
_ABS_EPS_FLOOR = 1e-12   # all-zero vectors (len 0) still cluster together


@dataclasses.dataclass(frozen=True)
class ClusterResult:
    labels: Tuple[int, ...]             # cluster id per process, dense from 0
    clusters: Tuple[Tuple[int, ...], ...]  # members per cluster id
    isolated: Tuple[int, ...]           # ranks that are singleton clusters

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    def partition(self) -> Tuple[Tuple[int, ...], ...]:
        return canonical_partition(self.labels)

    def same_output(self, other: "ClusterResult") -> bool:
        """Paper Step 2: 'the number of clusters or members of a cluster
        changed' == the partition changed."""
        return self.partition() == other.partition()

    def render(self, kind: str = "kind") -> str:
        lines = [f"there are {self.n_clusters} kinds of processes"
                 if self.n_clusters != 1 else "there is 1 kind of processes"]
        for cid, members in enumerate(self.clusters):
            lines.append(f"{kind} {cid}: " + " ".join(str(x) for x in members))
        return "\n".join(lines)


def _eps(ln: np.ndarray, i: int) -> float:
    return max(EPS_FRACTION * float(ln[i]), _ABS_EPS_FLOOR)


def reachability_graph(sq_blocks, eps: np.ndarray,
                       exact: bool = True) -> np.ndarray:
    """Boolean eps-reachability graph from squared-distance row blocks:
    ``reach[p, q]`` means q is in N(p) (row-wise eps => directed).

    Compares squared distances against eps^2 — no m x m sqrt.  With
    ``exact=True`` any entry within a few ulps of the threshold is re-checked
    with the exact ``sqrt(d2) < eps`` comparison, so the graph matches the
    reference's ``dist < eps`` bit for bit.  Callers whose ``d2`` is itself
    an ulp-level approximation (the search fast path's downdated matrices)
    pass ``exact=False`` to skip the band scan, which buys them nothing.
    """
    m = len(eps)
    eps2 = eps * eps
    reach = np.empty((m, m), dtype=bool)
    for start, stop, d2 in sq_blocks:
        e2 = eps2[start:stop, None]
        if not exact:
            np.less(d2, e2, out=reach[start:stop])
            continue
        lo = (eps2 * (1.0 - 4e-15))[start:stop, None]
        hi = (eps2 * (1.0 + 4e-15))[start:stop, None]
        np.less(d2, hi, out=reach[start:stop])
        band = reach[start:stop] != (d2 < lo)
        if band.any():
            rows, cols = np.nonzero(band)
            reach[start + rows, cols] = \
                np.sqrt(np.maximum(d2[rows, cols], 0.0)) < eps[start + rows]
    return reach


def robust_reachability_graph(d2: np.ndarray, eps: np.ndarray,
                              margin: np.ndarray) -> Optional[np.ndarray]:
    """Certified eps-reachability graph for collapsed (approximate) points.

    ``d2`` holds squared distances between group representatives, ``eps``
    each representative's row threshold, and ``margin[g, h]`` a bound on how
    far the member-level comparison ``dist(p, q) < eps_p`` (any p in group
    g, any q in group h) can drift from the representative-level one — for
    balls of radius ``delta`` around actual data rows that is
    ``1.1 * delta[g] + delta[h]`` (the distance moves by at most
    ``delta[g] + delta[h]`` and the anchor's eps, 10% of a 1-Lipschitz
    norm, by at most ``0.1 * delta[g]``).

    Returns the boolean graph when *every* pair is decided robustly:
    ``d >= eps + margin`` (no member pair has the edge) or ``0 < eps -
    margin`` and ``d < eps - margin`` (every member pair has it).  The
    diagonal doubles as the in-group condition: ``d2[g, g] == 0`` is a
    robust edge iff ``eps[g] > margin[g, g]`` (= ``2.1 * delta[g]``), i.e.
    the ball is provably an eps-clique of its own members.  Returns
    ``None`` as soon as one pair falls inside the band — a member edge
    could then differ from its representative edge and the caller must
    take the exact path.

    All comparisons run in the squared domain (no r x r sqrt); ``d2`` may
    carry tiny negatives from downdating cancellation, which land on the
    robust-edge side exactly as a true zero distance would.
    """
    eps_col = eps[:, None]
    lo = eps_col - margin
    hi = eps_col + margin
    edge = (lo > 0.0) & (d2 < lo * lo)
    if bool(np.all(edge | (d2 >= hi * hi))):
        return edge
    return None


def cluster_labels(reach: np.ndarray, count_threshold: int = COUNT_THRESHOLD,
                   weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Density closure over a reachability graph, vectorized: returns the
    dense cluster label per point, ``-1`` for points absorbed by no cluster.

    Equivalent of the sequential anchor/queue expansion: with *core* points
    those having ``|N(p)| >= count_threshold``, the per-point Python queue
    becomes a frontier BFS over whole boolean rows — each sweep labels the
    union of the frontier cores' neighbourhoods in one reduction, and the
    new frontier is the cores just labeled.  Every core row enters exactly
    one reduction, so the closure costs one pass over the graph.  The set
    computed is the same density closure the queue computes (closure is
    order-independent; border points are claimed by the earliest-formed
    cluster in both), so the labels are bit-identical to the reference.

    ``weights`` supports collapsed duplicate points (the search fast path):
    point p then stands for ``weights[p]`` identical processes and its
    neighbourhood size is the weighted degree ``reach[p] @ weights``.
    """
    m = reach.shape[0]
    labels = np.full(m, -1, dtype=np.int64)
    if m == 0:
        return labels
    if weights is None:
        core_mask = reach.sum(axis=1) >= count_threshold
    else:
        core_mask = reach @ weights >= count_threshold
    next_label = 0
    for anchor in np.flatnonzero(core_mask):
        if labels[anchor] >= 0:
            continue
        labels[anchor] = next_label
        frontier = np.asarray([anchor])
        while frontier.size:
            territory = np.logical_or.reduce(reach[frontier], axis=0)
            new = np.flatnonzero(territory & (labels < 0))
            labels[new] = next_label
            frontier = new[core_mask[new]]
        next_label += 1
    return labels


def labels_to_result(labels: np.ndarray) -> ClusterResult:
    """Finalize closure labels into a :class:`ClusterResult`: unlabeled
    points become singleton clusters and ids are renumbered by smallest
    member rank (a border point of a later cluster may have a smaller rank
    than that cluster's anchor), exactly as the reference does."""
    m = len(labels)
    labels = np.asarray(labels, dtype=np.int64).copy()
    isolated = tuple(int(i) for i in np.flatnonzero(labels < 0))
    next_label = int(labels.max()) + 1 if m else 0
    for i in isolated:
        labels[i] = next_label
        next_label += 1
    first_member = np.full(next_label, m, dtype=np.int64)
    np.minimum.at(first_member, labels, np.arange(m))
    remap = np.empty(next_label, dtype=np.int64)
    remap[np.argsort(first_member, kind="stable")] = np.arange(next_label)
    labels = remap[labels]
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(next_label + 1))
    clusters_t = tuple(tuple(int(i) for i in order[bounds[c]:bounds[c + 1]])
                       for c in range(next_label))
    return ClusterResult(tuple(int(l) for l in labels), clusters_t, isolated)


def cluster_eps(ln: np.ndarray, eps_fraction: float = EPS_FRACTION
                ) -> np.ndarray:
    """Per-point neighbourhood thresholds (same floats as the reference's
    scalar ``max(eps_fraction * len_i, floor)``)."""
    return np.maximum(eps_fraction * ln, _ABS_EPS_FLOOR)


def cluster(perf, eps_fraction: float = EPS_FRACTION,
            count_threshold: int = COUNT_THRESHOLD) -> ClusterResult:
    """Cluster process performance vectors (rows of ``perf``).

    Returns a deterministic :class:`ClusterResult`.  With a single process
    the result is trivially one cluster.  Fully vectorized
    (:func:`reachability_graph` from blocked squared distances +
    :func:`cluster_labels` closure), bit-identical to
    ``core._reference.cluster_reference`` in the single-distance-block
    regime (m^2 floats within ``DIST_BLOCK_BYTES``, i.e. m <= ~2048 —
    everything the reference can realistically be run against); beyond
    that, per-block GEMMs may round differently from the reference's full
    GEMM in the final ulp, far below the 10%-of-norm eps margins.
    """
    perf = as_matrix(perf)
    m = perf.shape[0]
    if m == 0:
        return ClusterResult((), (), ())
    eps = cluster_eps(lengths(perf), eps_fraction)
    reach = reachability_graph(iter_sqdistance_blocks(perf), eps)
    return labels_to_result(cluster_labels(reach, count_threshold))


def reachability_order(perf, eps_fraction: float = EPS_FRACTION,
                       min_pts: int = COUNT_THRESHOLD + 1
                       ) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """Classic OPTICS ordering (Ankerst et al. 1999) for diagnostics.

    Returns (visit order, reachability distance per visited point); the first
    point of each density valley has reachability ``inf``.

    The seed list is a binary heap (lazy deletion: stale entries are skipped
    when popped) instead of a re-sorted Python list; each pop still yields
    the globally smallest ``(reachability, rank)`` pair, so the visit order
    is identical to the reference implementation's sort-per-pop loop.
    """
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
        seeds: List[Tuple[float, int]] = [(np.inf, start)]
        while seeds:
            r, p = heapq.heappop(seeds)
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
                        heapq.heappush(seeds, (newr, int(q)))
    return tuple(order), tuple(float(reach[i]) for i in order)
