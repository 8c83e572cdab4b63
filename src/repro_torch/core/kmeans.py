"""Deterministic k-means for severity classification (paper §3.3.2, Fig. 3).

The paper classifies scalar metrics (average CRNM per region, average
attribute values for the rough-set tables) into five severity categories:

    very high (4), high (3), medium (2), low (1), very low (0)

k-means "can classify the data into k clusters without the threshold value
provided by users".  In 1-D the k-means objective has an exact DP minimizer
(Ckmeans.1d.dp, Wang & Song 2011); we use it instead of Lloyd iterations,
which are seed-sensitive and can leave interior classes empty on gappy
severity data.  Clusters map to severity classes by ascending centroid.

The DP layer transition ``D[m][i] = min_j D[m-1][j] + sse(j, i)`` has a
totally monotone cost matrix (the SSE weight satisfies the concave
quadrangle inequality), so the per-layer argmins are found with the
divide-and-conquer monotone-argmin optimization in O(n log n) instead of
the reference's O(n^2) scan — O(k n log n) overall.  Both the production
implementations here and the retained reference
(``core._reference.optimal_1d_partition_reference``) pick the *leftmost*
argmin, so labels and centroids are identical (enforced by property tests).
Below ``_DENSE_MAX_N`` — and for inputs with duplicate values, whose exact
cost ties are unsafe for the range-restricting D&C (see
``_optimal_1d_partition``) — a fully vectorized per-layer scan (same
asymptotics as the reference but one numpy argmin per layer) wins on
constant factors and is provably tie-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

N_SEVERITY = 5
SEVERITY_NAMES = ("very low", "low", "medium", "high", "very high")

_DENSE_MAX_N = 128   # n*n layer matrices stay cache-resident; D&C above


@dataclasses.dataclass(frozen=True)
class KMeansResult:
    labels: Tuple[int, ...]      # severity class per item (0..k-1, ascending)
    centroids: Tuple[float, ...]  # ascending centroid per class

    def members(self, severity: int) -> Tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.labels) if l == severity)

    def render(self) -> str:
        lines = []
        for sev in range(len(SEVERITY_NAMES) - 1, -1, -1):
            mem = self.members(sev)
            if mem:
                lines.append(f"{SEVERITY_NAMES[sev]}: " +
                             ", ".join(str(i) for i in mem))
        return "\n".join(lines)


def _layer1(pre: np.ndarray, pre2: np.ndarray, n: int,
            cw: Optional[np.ndarray] = None) -> np.ndarray:
    """D[1][i] = sse(0, i): one cluster covering sorted[0..i-1].

    Matches the reference's first layer exactly: there j=0 is the only
    finite candidate and ``0.0 + sse == sse``.  ``cw`` is the cumulative
    point-weight prefix (weighted inputs); by default every point weighs 1
    and the divisor is the plain count — the same floats as before.
    """
    i = np.arange(n + 1, dtype=np.float64) if cw is None else cw
    with np.errstate(invalid="ignore", divide="ignore"):
        s = pre - pre[0]
        out = pre2 - pre2[0] - s * s / i
    out[0] = np.inf   # D[1][0] stays INF as in the reference table
    return out


def _dense_layer(pre: np.ndarray, pre2: np.ndarray, d_prev: np.ndarray,
                 m: int, n: int, cw: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One DP layer via (rows x candidates) cost matrices + row argmin.

    Bit-identical to the reference row loop: the cost expression is the
    same elementwise formula, invalid candidates are +inf, and ``argmin``
    picks the first (smallest j) minimum exactly like the reference's
    per-row ``np.argmin``.  Rows are processed in chunks so the layer's
    temporaries stay O(_DENSE_MAX_N^2) even when a duplicate-carrying
    large input is routed here (the D&C path cannot take it, see
    ``_optimal_1d_partition``) — the reference's memory envelope, not a
    quadratic regression of it.
    """
    d_m = np.full(n + 1, np.inf)
    arg_m = np.zeros(n + 1, dtype=np.int64)
    j = np.arange(n + 1)
    chunk = max(1, (_DENSE_MAX_N * _DENSE_MAX_N) // (n + 1))
    for lo in range(m, n + 1, chunk):
        i = np.arange(lo, min(lo + chunk, n + 1))
        if cw is None:
            cnt = i[:, None] - j[None, :]
        else:
            cnt = cw[i][:, None] - cw[None, :]
        valid = (j[None, :] >= m - 1) & (cnt > 0)
        with np.errstate(invalid="ignore", divide="ignore"):
            s = pre[i][:, None] - pre[None, :]
            sse = pre2[i][:, None] - pre2[None, :] - s * s / cnt
            cost = d_prev[None, :] + sse
        cost[~valid] = np.inf
        best = np.argmin(cost, axis=1)
        d_m[i] = cost[np.arange(len(i)), best]
        arg_m[i] = best
    return d_m, arg_m


def _dc_layer(pre: np.ndarray, pre2: np.ndarray, d_prev: np.ndarray,
              m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """One DP layer via divide-and-conquer monotone argmin, O(n log n).

    Level-by-level: each node handles the middle row of its row interval,
    restricted to the candidate interval its parent's argmin allows.  All
    nodes of a level are evaluated in one batched, segmented computation
    (``np.minimum.reduceat`` for segment minima, an index trick for the
    *first* position of each minimum — the leftmost-argmin tie-break the
    reference's ``np.argmin`` uses).
    """
    d_m = np.full(n + 1, np.inf)
    arg_m = np.zeros(n + 1, dtype=np.int64)
    # nodes: (ilo, ihi, jlo, jhi) with rows ilo..ihi, candidates jlo..jhi
    nodes = [(m, n, m - 1, n - 1)]
    while nodes:
        mids = np.asarray([(ilo + ihi) // 2 for ilo, ihi, _, _ in nodes])
        jlo = np.asarray([nd[2] for nd in nodes])
        jhi = np.minimum(np.asarray([nd[3] for nd in nodes]), mids - 1)
        lens = jhi - jlo + 1                      # >= 1 by construction
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        total = int(lens.sum())
        # ragged arange: candidate j for every (node, offset) pair
        js = np.arange(total) - np.repeat(starts, lens) + np.repeat(jlo, lens)
        mid_of = np.repeat(mids, lens)
        with np.errstate(invalid="ignore", divide="ignore"):
            s = pre[mid_of] - pre[js]
            cost = d_prev[js] + (pre2[mid_of] - pre2[js]
                                 - s * s / (mid_of - js))
        seg_min = np.minimum.reduceat(cost, starts)
        # first index of the minimum inside each segment (leftmost argmin)
        pos = np.arange(total)
        pos[cost != np.repeat(seg_min, lens)] = total
        first = np.minimum.reduceat(pos, starts)
        opt = js[first]
        d_m[mids] = seg_min
        arg_m[mids] = opt
        nxt = []
        for t, (ilo, ihi, lo, hi) in enumerate(nodes):
            mid, o = int(mids[t]), int(opt[t])
            if ilo < mid:
                nxt.append((ilo, mid - 1, lo, o))
            if mid < ihi:
                nxt.append((mid + 1, ihi, o, hi))
        nodes = nxt
    return d_m, arg_m


def _optimal_1d_partition(sorted_vals: np.ndarray, k: int) -> np.ndarray:
    """Exact 1-D k-means via DP.  Returns cluster id (0..k-1 ascending) for
    each element of the *sorted* array.  Same labels as
    ``core._reference.optimal_1d_partition_reference`` on every input.

    The monotone-argmin D&C requires the leftmost per-row argmins to be
    non-decreasing, which the SSE cost guarantees analytically but float
    rounding can break when costs *tie exactly* — and duplicate values
    saturate the DP with exact ties.  Inputs containing duplicates
    therefore take the dense layer (full-range argmin, provably identical
    to the reference on every input); the subquadratic path is reserved
    for large all-distinct inputs, where remaining tie-risk is confined to
    exactly-symmetric rational spacings that measured data does not hit.
    """
    n = len(sorted_vals)
    pre = np.concatenate([[0.0], np.cumsum(sorted_vals)])
    pre2 = np.concatenate([[0.0], np.cumsum(sorted_vals ** 2)])
    has_dups = n > 1 and bool(np.any(sorted_vals[1:] == sorted_vals[:-1]))
    layer = _dense_layer if (n <= _DENSE_MAX_N or has_dups) else _dc_layer

    d_prev = _layer1(pre, pre2, n)
    args = [np.zeros(n + 1, dtype=np.int64)]      # layer 1: j == 0
    for m in range(2, k + 1):
        d_prev, arg_m = layer(pre, pre2, d_prev, m, n)
        args.append(arg_m)
    # backtrack boundaries
    labels = np.zeros(n, dtype=np.int64)
    i = n
    for m in range(k, 1, -1):
        j = int(args[m - 1][i])
        labels[j:i] = m - 1
        i = j
    return labels


def _optimal_1d_partition_weighted(sorted_vals: np.ndarray,
                                   weights: np.ndarray, k: int) -> np.ndarray:
    """Weighted exact 1-D k-means DP over *distinct, sorted* values: point
    ``i`` stands for ``weights[i]`` identical observations.  This is the
    collapsed form of running the unweighted DP on the weight-expanded
    array — the SSE of an interval depends only on the weighted prefix
    sums, so the transition is the same formula with counts replaced by
    cumulative weights.  Always routed through the dense layer: weighted
    points *are* collapsed duplicates, exactly the tie-unsafe case the
    divide-and-conquer path refuses (see ``_optimal_1d_partition``)."""
    n = len(sorted_vals)
    w = np.asarray(weights, dtype=np.float64)
    pre = np.concatenate([[0.0], np.cumsum(w * sorted_vals)])
    pre2 = np.concatenate([[0.0], np.cumsum(w * sorted_vals ** 2)])
    cw = np.concatenate([[0.0], np.cumsum(w)])
    d_prev = _layer1(pre, pre2, n, cw)
    args = [np.zeros(n + 1, dtype=np.int64)]      # layer 1: j == 0
    for m in range(2, k + 1):
        d_prev, arg_m = _dense_layer(pre, pre2, d_prev, m, n, cw)
        args.append(arg_m)
    labels = np.zeros(n, dtype=np.int64)
    i = n
    for m in range(k, 1, -1):
        j = int(args[m - 1][i])
        labels[j:i] = m - 1
        i = j
    return labels


def _kmeans_1d_weighted(values: Sequence[float], weights: Sequence[float],
                        k: int) -> KMeansResult:
    """Weighted k-means body: merge equal values (their weights add — one
    weighted point can only carry one label), run the weighted DP, expand
    labels back, and rescale sparse class counts exactly like the
    unweighted path."""
    vals = np.asarray(values, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if vals.ndim != 1 or w.shape != vals.shape:
        raise ValueError("kmeans_1d weights must be 1-D and match values")
    if np.any(w <= 0):
        raise ValueError("kmeans_1d weights must be positive")
    n = len(vals)
    if n == 0:
        return KMeansResult((), ())
    uniq, inv = np.unique(vals, return_inverse=True)
    uw = np.zeros(len(uniq))
    np.add.at(uw, inv, w)
    k_eff = int(min(k, len(uniq)))
    if k_eff == 1:
        return KMeansResult(tuple([0] * n), (float(uniq[0]),))
    lab_u = _optimal_1d_partition_weighted(uniq, uw, k_eff)
    labels = lab_u[inv]
    centroids = np.asarray(
        [float(np.dot(uw[lab_u == c], uniq[lab_u == c]) / np.sum(uw[lab_u == c]))
         for c in range(k_eff)])
    if k_eff < k:
        scale = (k - 1) / max(k_eff - 1, 1)
        labels = np.round(labels * scale).astype(np.int64)
    return KMeansResult(tuple(int(l) for l in labels),
                        tuple(float(c) for c in centroids))


def _kmeans_1d_with(partition_fn, values: Sequence[float],
                    k: int) -> KMeansResult:
    """Shared k-means body (validation, k_eff handling, centroid + severity
    rescale) parameterized by the sorted-array partitioner, so production
    and the reference oracle can never drift apart."""
    vals = np.asarray(values, dtype=np.float64)
    if vals.ndim != 1:
        raise ValueError("kmeans_1d expects a 1-D array")
    n = len(vals)
    if n == 0:
        return KMeansResult((), ())
    distinct = np.unique(vals)
    k_eff = int(min(k, len(distinct)))
    if k_eff == 1:
        return KMeansResult(tuple([0] * n), (float(distinct[0]),))

    order = np.argsort(vals, kind="stable")
    lab_sorted = partition_fn(vals[order], k_eff)
    labels = np.empty(n, dtype=np.int64)
    labels[order] = lab_sorted
    centroids = np.asarray([float(np.mean(vals[labels == c]))
                            for c in range(k_eff)])
    if k_eff < k:
        scale = (k - 1) / max(k_eff - 1, 1)
        labels = np.round(labels * scale).astype(np.int64)
    return KMeansResult(tuple(int(l) for l in labels),
                        tuple(float(c) for c in centroids))


def kmeans_1d(values: Sequence[float], k: int = N_SEVERITY,
              weights: Optional[Sequence[float]] = None) -> KMeansResult:
    """Exact 1-D k-means.  If there are fewer distinct values than ``k``,
    each distinct value becomes its own cluster and labels are rescaled onto
    the k-point severity scale (so the top value is always 'very high').

    ``weights`` (positive, same length as ``values``) is the
    weighted-representative handoff for collapsed inputs: value ``i``
    stands for ``weights[i]`` identical observations, and the result
    matches running the unweighted DP on the weight-expanded array —
    labels per representative, centroids as weighted means.

    The exact DP needs no iteration cap — the former ``max_iter`` parameter
    (a Lloyd-era leftover that was never read) is gone.
    """
    if weights is not None:
        return _kmeans_1d_weighted(values, weights, k)
    return _kmeans_1d_with(_optimal_1d_partition, values, k)


def kmeans_1d_reference(values: Sequence[float],
                        k: int = N_SEVERITY) -> KMeansResult:
    """`kmeans_1d` driven by the retained O(n^2 k) reference DP — the
    property-test oracle for the dense and divide-and-conquer layers."""
    from ._reference import optimal_1d_partition_reference
    return _kmeans_1d_with(optimal_1d_partition_reference, values, k)


def severity_classes(values: Sequence[float],
                     weights: Optional[Sequence[float]] = None) -> KMeansResult:
    """Paper's 5-class severity classification (optionally over weighted
    representatives of collapsed groups)."""
    return kmeans_1d(values, k=N_SEVERITY, weights=weights)
