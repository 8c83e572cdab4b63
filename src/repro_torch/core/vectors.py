"""Performance vectors and the dissimilarity-severity metric S (paper §3.2.1).

Each process/shard ``i`` is represented by a vector ``V_i = <T_i1 .. T_in>``
whose t-th component is the CPU (device-busy) time of code region t in that
process.  The matrix convention throughout ``repro.core`` is

    perf[m, n]  --  m processes (ranks/shards)  x  n regions.

Column order follows ``RegionTree.ids()``.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

# Row-wise memory bound for blocked pairwise-distance computation: one block
# of the distance matrix never exceeds this many bytes of float64 (the m x m
# matrix for m=4096 would be 128 MiB; blocks keep the analysis thread's
# footprint flat no matter how many ranks a merged pod snapshot carries).
DIST_BLOCK_BYTES = 32 * 2 ** 20


def as_matrix(perf) -> np.ndarray:
    m = np.asarray(perf, dtype=np.float64)
    if m.ndim != 2:
        raise ValueError(f"performance data must be 2-D (m procs x n regions), got {m.shape}")
    return m


def pairwise_distances(perf: np.ndarray) -> np.ndarray:
    """Euclidean distance matrix between process vectors (paper Eq. 1)."""
    perf = as_matrix(perf)
    sq = np.sum(perf * perf, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (perf @ perf.T)
    return np.sqrt(np.maximum(d2, 0.0))


def iter_sqdistance_blocks(perf: np.ndarray,
                           block_rows: Optional[int] = None
                           ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield the *squared* distance matrix in row blocks
    ``(start, stop, d2_block)``.

    ``d2_block`` holds exactly the same floats as the intermediate ``d2``
    inside :func:`pairwise_distances` — same expression, same evaluation
    order — so ``sqrt(max(d2_block, 0))`` is bit-identical to the distances
    (IEEE sqrt is correctly rounded).  Entries may be tiny negatives from
    cancellation; consumers comparing against positive thresholds need no
    clamp, and skipping the m x m clamp + sqrt is the main win for the
    clustering hot path, which only ever *compares* distances.

    The default block height keeps each block under ``DIST_BLOCK_BYTES``
    (the row-wise memory bound: one block of float64, never the full m x m
    matrix).  For matrices that fit in a single block the underlying GEMM is
    the same call the reference implementation makes; for larger matrices
    the per-block GEMM may differ from the full-matrix one in the last ulp
    (BLAS blocking), which is far below the eps margins at that scale.
    """
    perf = as_matrix(perf)
    m = perf.shape[0]
    if m == 0:
        return
    if block_rows is None:
        block_rows = max(1, DIST_BLOCK_BYTES // max(8 * m, 8))
    sq = np.sum(perf * perf, axis=1)
    pt = perf.T
    for start in range(0, m, block_rows):
        stop = min(start + block_rows, m)
        d2 = sq[start:stop, None] + sq[None, :]
        d2 -= 2.0 * (perf[start:stop] @ pt)
        yield start, stop, d2


def iter_distance_blocks(perf: np.ndarray,
                         block_rows: Optional[int] = None
                         ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield the distance matrix in row blocks ``(start, stop, dist_block)``;
    rows ``start:stop`` of :func:`pairwise_distances` under the same memory
    bound as :func:`iter_sqdistance_blocks`."""
    for start, stop, d2 in iter_sqdistance_blocks(perf, block_rows):
        np.maximum(d2, 0.0, out=d2)
        yield start, stop, np.sqrt(d2)


def lengths(perf: np.ndarray) -> np.ndarray:
    """Vector norms len_i (paper Eq. 3)."""
    return np.sqrt(np.sum(as_matrix(perf) ** 2, axis=1))


def severity_S(perf: np.ndarray) -> float:
    """Dissimilarity severity S = max(Dist_ij) / min(len_i) (paper Eq. 2).

    Larger S == more severe performance dissimilarity across processes.
    A program whose processes are identical has S == 0.
    """
    perf = as_matrix(perf)
    if perf.shape[0] < 2:
        return 0.0
    # max of sqrt == sqrt of max (correctly-rounded sqrt is monotone), so the
    # elementwise m x m sqrt of the reference expression is not needed.
    max_d2 = 0.0   # the clamp of pairwise_distances, applied to the scalar
    for _, _, blk in iter_sqdistance_blocks(perf):
        max_d2 = max(max_d2, float(np.max(blk)))
    max_dist = float(np.sqrt(max_d2))
    ln = lengths(perf)
    min_len = float(np.min(ln))
    if min_len <= 0.0:
        # Degenerate: some process did no measured work.  Fall back to the
        # mean norm so S stays finite (the clustering still flags the outlier).
        min_len = float(np.mean(ln)) or 1.0
    return max_dist / min_len


def zero_columns(perf: np.ndarray, cols: Sequence[int]) -> np.ndarray:
    out = as_matrix(perf).copy()
    if len(cols):
        out[:, list(cols)] = 0.0
    return out


def keep_columns(perf: np.ndarray, cols: Sequence[int]) -> np.ndarray:
    """Zero every column *except* ``cols`` (preserves vector dimensionality,
    as the paper's searching algorithm requires)."""
    perf = as_matrix(perf)
    out = np.zeros_like(perf)
    if len(cols):
        out[:, list(cols)] = perf[:, list(cols)]
    return out


def ball_group_rows(X: np.ndarray, radius: float,
                    max_groups: Optional[int] = None
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Greedy leader grouping of rows into Euclidean balls of ``radius``.

    Deterministic: the first (lowest-index) ungrouped row becomes the next
    leader, and every later row within ``radius`` of it joins that group —
    one vectorized distance pass over the remaining rows per leader, so
    the cost is O(groups * m * n) worst case and O(m * n) per *effective*
    group when the data really is a few jittered clouds.  Group ids are
    dense and ordered by leader index (ascending row order).

    Returns ``(gid, leaders, delta)`` where ``gid[i]`` is row i's group,
    ``leaders[g]`` the representative row index, and ``delta[g]`` the
    *measured* max distance from any member to its leader (the collapse
    radius certificates are built from — the greedy assignment is only a
    heuristic, ``delta`` is what makes it sound).  Returns ``None`` when
    more than ``max_groups`` leaders emerge: the grouping would not pay
    for itself and the caller should keep the exact representation.
    """
    X = as_matrix(X)
    m = X.shape[0]
    gid = np.full(m, -1, dtype=np.int64)
    leaders: list = []
    deltas: list = []
    remaining = np.arange(m)
    while remaining.size:
        lead = int(remaining[0])
        diff = X[remaining] - X[lead]
        d = np.sqrt(np.einsum("ij,ij->i", diff, diff))
        mask = d <= radius
        gid[remaining[mask]] = len(leaders)
        leaders.append(lead)
        deltas.append(float(np.max(d[mask])))
        remaining = remaining[~mask]
        if max_groups is not None and len(leaders) > max_groups:
            return None
    return (gid, np.asarray(leaders, dtype=np.int64),
            np.asarray(deltas, dtype=np.float64))


def canonical_partition(labels: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """Canonical form of a clustering result: clusters as sorted tuples of
    member indices, ordered by smallest member.  Two clusterings are 'the
    same output' (paper Step 2/3) iff their canonical partitions match."""
    groups: dict = {}
    for idx, lab in enumerate(labels):
        groups.setdefault(lab, []).append(idx)
    return tuple(sorted(tuple(sorted(g)) for g in groups.values()))
