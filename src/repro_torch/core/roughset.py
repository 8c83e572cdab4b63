"""Rough-set root-cause analysis (paper §3.4.1).

Pipeline:  decision table  ->  discernibility matrix (Eq. 5)  ->  core
attribute extraction (Steps 1-3: singleton cores, CNF of uncovered clauses,
CNF->DNF with absorption, minimal conjunct selection).

The *core* attribute set is reported as the root cause(s) of the bottlenecks
described by the table.  Ties (paper's Table 1 example yields {a1,a2} or
{a1,a3}) are preserved: ``cores`` lists every minimal alternative, and
``core`` is the union of attributes certain to matter plus the first
alternative (deterministic).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

# Sentinels matching the paper's Eq. 5
SAME_DECISION = 0      # decisions equal -> no constraint
INDISCERNIBLE = -1     # decisions differ but no attribute does (inconsistent)

# ---------------------------------------------------------------------------
# Attribute roles
# ---------------------------------------------------------------------------
# The paper reads its rough-set cores through the *meaning* of the five PAPI
# attributes (a core naming ``instructions`` => work imbalance => re-shard;
# ``network_io`` => communication; ...).  Those meanings are not properties
# of the analyzer — they are properties of whatever attribute set the
# collection schema declared.  Schemas therefore tag each attribute field
# with a semantic *role* from this vocabulary, and every downstream consumer
# (policies, verdict rendering, drivers) interprets cores via roles instead
# of hardcoded attribute names — so a schema can add or rename cost fields
# without touching the analyzer.

ROLE_WORK = "work"        # amount of work handed to a process (instructions,
                          # HLO flops): an imbalanced core => repartition data
ROLE_NETWORK = "network"  # inter-process communication volume (network I/O,
                          # collective bytes)
ROLE_MEMORY = "memory"    # memory-hierarchy boundedness (cache miss rates,
                          # HBM/vmem pressure ratios)
ROLE_IO = "io"            # host/disk I/O volume (disk bytes, host transfers)

ATTRIBUTE_ROLES = (ROLE_WORK, ROLE_NETWORK, ROLE_MEMORY, ROLE_IO)


@dataclasses.dataclass(frozen=True)
class DecisionTable:
    """entries x attributes with one decision column.

    ``attrs[i][a]`` is the (discretized) value of attribute ``a`` for entry i;
    values may be any hashable (ints from clustering, strings, ...).
    """

    entry_ids: Tuple[object, ...]
    attr_names: Tuple[str, ...]
    rows: Tuple[Tuple[object, ...], ...]   # len(entry_ids) x len(attr_names)
    decisions: Tuple[object, ...]

    def __post_init__(self):
        if len(self.rows) != len(self.entry_ids) or len(self.decisions) != len(self.entry_ids):
            raise ValueError("decision table shape mismatch")
        for r in self.rows:
            if len(r) != len(self.attr_names):
                raise ValueError("row width != number of attributes")

    @classmethod
    def build(cls, attr_names: Sequence[str], rows: Sequence[Sequence[object]],
              decisions: Sequence[object],
              entry_ids: Optional[Sequence[object]] = None) -> "DecisionTable":
        if entry_ids is None:
            entry_ids = tuple(range(len(rows)))
        return cls(tuple(entry_ids), tuple(attr_names),
                   tuple(tuple(r) for r in rows), tuple(decisions))

    def render(self) -> str:  # pragma: no cover - cosmetic
        head = ["ID"] + list(self.attr_names) + ["D"]
        lines = ["\t".join(head)]
        for eid, row, dec in zip(self.entry_ids, self.rows, self.decisions):
            lines.append("\t".join(str(x) for x in (eid, *row, dec)))
        return "\n".join(lines)


def discernibility_matrix(table: DecisionTable) -> List[List[object]]:
    """Upper-triangular discernibility matrix per Eq. 5.

    Element c_ij is: SAME_DECISION (0) when decisions agree; a frozenset of
    differing attribute names when decisions differ; INDISCERNIBLE (-1) when
    decisions differ but the rows are attribute-identical (inconsistent
    table).
    """
    n = len(table.entry_ids)
    mat: List[List[object]] = [[SAME_DECISION] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if table.decisions[i] == table.decisions[j]:
                continue
            diff = frozenset(
                a for a, vi, vj in zip(table.attr_names, table.rows[i], table.rows[j])
                if vi != vj)
            mat[i][j] = diff if diff else INDISCERNIBLE
            mat[j][i] = mat[i][j]
    return mat


def _absorb(clauses: List[FrozenSet[str]]) -> List[FrozenSet[str]]:
    """CNF absorption: drop any clause that is a superset of another."""
    out: List[FrozenSet[str]] = []
    for c in sorted(set(clauses), key=lambda s: (len(s), sorted(s))):
        if not any(kept <= c for kept in out):
            out.append(c)
    return out


@dataclasses.dataclass(frozen=True)
class CoreResult:
    singletons: Tuple[str, ...]            # attributes certain to be in any core
    cores: Tuple[Tuple[str, ...], ...]     # minimal alternative cores (sorted)
    inconsistent_pairs: int                # count of INDISCERNIBLE entries

    @property
    def core(self) -> Tuple[str, ...]:
        """Deterministic single answer: first minimal alternative."""
        return self.cores[0] if self.cores else ()

    def render(self) -> str:  # pragma: no cover - cosmetic
        alts = " or ".join("{" + ", ".join(c) + "}" for c in self.cores)
        return f"core set: {alts or '{}'}"


#: sentinel for a row group whose members carry more than one decision (any
#: entry from another group discerns against *some* member of it)
_MANY = object()

#: distinct-row-group count above which the clause sweep switches from the
#: per-pair Python loop to the vectorized bitmask path (when it applies)
_VECTOR_MIN_GROUPS = 64


def _discernibility_clauses(table: DecisionTable
                            ) -> Tuple[set, int]:
    """Distinct discernibility clauses + exact INDISCERNIBLE pair count.

    The full matrix (Eq. 5) is O(entries^2) Python pairs, but
    :func:`extract_core` only consumes (a) the *set* of distinct clauses
    (Steps 1-3 dedup and absorb; multiplicity never matters) and (b) the
    exact count of indiscernible pairs.  Both survive collapsing identical
    attribute rows into weighted groups:

    * a pair of entries from the *same* row group is indiscernible iff
      their decisions differ — count = sum over groups of the cross-decision
      member-pair products, computed from the per-decision counts;
    * a pair from *different* row groups always differs in some attribute,
      and its clause depends only on the two rows — so one clause per group
      pair, skipped entirely when both groups carry the same single
      decision.

    SPMD decision tables collapse hard (cluster-id rows repeat across
    ranks), so the sweep runs over G distinct rows instead of m entries.
    When G stays large (fully noisy data) and every attribute row is
    hashable-int-codable, the pairwise sweep is vectorized: rows become
    int codes, each clause a <=63-bit difference mask computed by a numpy
    comparison against all later rows at once.
    """
    names = table.attr_names
    na = len(names)
    row_index: Dict[Tuple[object, ...], int] = {}
    dec_counts: List[Dict[object, int]] = []
    for row, dec in zip(table.rows, table.decisions):
        g = row_index.setdefault(row, len(dec_counts))
        if g == len(dec_counts):
            dec_counts.append({})
        dc = dec_counts[g]
        dc[dec] = dc.get(dec, 0) + 1
    rows_g = list(row_index)            # insertion order == group id
    G = len(rows_g)

    inconsistent = 0
    for dc in dec_counts:
        if len(dc) > 1:
            total = sum(dc.values())
            inconsistent += (total * total - sum(c * c for c in dc.values())) // 2

    # a group's decision "signature": its single decision, or _MANY
    single = [next(iter(dc)) if len(dc) == 1 else _MANY for dc in dec_counts]

    clauses: set = set()
    if G > _VECTOR_MIN_GROUPS and 0 < na <= 63:
        # vectorized sweep: per-attribute value codes, clause = bitmask of
        # differing columns; one (G-g) x na comparison per leading group
        codes = np.empty((G, na), dtype=np.int64)
        for a in range(na):
            vocab: Dict[object, int] = {}
            codes[:, a] = [vocab.setdefault(rows_g[g][a], len(vocab))
                           for g in range(G)]
        dvocab: Dict[object, int] = {}
        dsig = np.asarray([-1 if s is _MANY else dvocab.setdefault(s, len(dvocab))
                           for s in single], dtype=np.int64)
        pow2 = np.left_shift(np.int64(1), np.arange(na, dtype=np.int64))
        masks: set = set()
        for g in range(G - 1):
            rest = np.arange(g + 1, G)
            if dsig[g] >= 0:
                rest = rest[dsig[rest] != dsig[g]]
            if not rest.size:
                continue
            diff = codes[rest] != codes[g]
            masks.update(np.unique(diff @ pow2).tolist())
        for mask in masks:
            clauses.add(frozenset(
                names[a] for a in range(na) if mask >> a & 1))
    else:
        for g in range(G - 1):
            rg, sg = rows_g[g], single[g]
            for h in range(g + 1, G):
                if sg is not _MANY and sg == single[h]:
                    continue
                clauses.add(frozenset(
                    a for a, vi, vj in zip(names, rg, rows_g[h]) if vi != vj))
    return clauses, inconsistent


def extract_core(table: DecisionTable) -> CoreResult:
    """Steps 1-3 of paper §3.4.1.

    The clause sweep runs over weighted groups of identical attribute rows
    (:func:`_discernibility_clauses`) instead of the full O(entries^2)
    matrix; the result is identical to running the steps over
    :func:`discernibility_matrix` — the property tests pin the equivalence
    against ``core._reference.extract_core_reference``.
    """
    clauses, inconsistent = _discernibility_clauses(table)
    if not clauses:
        return CoreResult((), ((),) if not inconsistent else (), inconsistent)

    # Step 1: singleton clauses are core attributes.
    cs = sorted({next(iter(c)) for c in clauses if len(c) == 1})
    cs_set = set(cs)

    # Step 2: keep only clauses untouched by the singleton core; absorb
    # supersets (the paper's example folds {a2,a3,a4} into {a2,a3}).
    remaining = _absorb([c for c in clauses if not (c & cs_set)])

    # Step 3: CNF -> DNF, pick minimal conjuncts by (size, frequency).
    if not remaining:
        return CoreResult(tuple(cs), (tuple(cs),), inconsistent)

    counts: Dict[FrozenSet[str], int] = {}
    for combo in itertools.product(*[sorted(c) for c in remaining]):
        key = frozenset(combo)
        counts[key] = counts.get(key, 0) + 1
    min_size = min(len(k) for k in counts)
    at_min = {k: v for k, v in counts.items() if len(k) == min_size}
    max_count = max(at_min.values())
    winners = sorted((tuple(sorted(cs_set | k)) for k, v in at_min.items()
                      if v == max_count))
    return CoreResult(tuple(cs), tuple(winners), inconsistent)


def root_causes(table: DecisionTable) -> CoreResult:
    """Alias with the paper's vocabulary: the core attributes of the decision
    table are the root causes of the bottlenecks it describes."""
    return extract_core(table)


# ---------------------------------------------------------------------------
# Decision-table builders (paper §3.4.2 / §3.4.3)
# ---------------------------------------------------------------------------

def external_decision_table(attr_names: Sequence[str],
                            attr_cluster_ids: np.ndarray,
                            decision_cluster_ids: Sequence[int]) -> DecisionTable:
    """External-bottleneck table (paper §3.4.2, Fig. 5).

    ``attr_cluster_ids[m, a]``: cluster id of process m under attribute a
    (each attribute's per-region vectors clustered with OPTICS, restricted to
    the CCCR regions).  Decision: cluster id of process m under CPU time.
    """
    ids = np.asarray(attr_cluster_ids)
    m, na = ids.shape
    if na != len(attr_names):
        raise ValueError("attribute count mismatch")
    rows = [tuple(int(x) for x in ids[i]) for i in range(m)]
    return DecisionTable.build(attr_names, rows,
                               [int(d) for d in decision_cluster_ids],
                               entry_ids=list(range(m)))


def internal_decision_table(attr_names: Sequence[str],
                            attr_flags: np.ndarray,
                            is_bottleneck: Sequence[bool],
                            region_ids: Sequence[int]) -> DecisionTable:
    """Internal-bottleneck table (paper §3.4.3, Fig. 6).

    ``attr_flags[r, a]``: 1 iff region r's average attribute a is classified
    above 'medium' severity by k-means, else 0.  Decision: region is an
    internal bottleneck (CCCR) or not.
    """
    flags = np.asarray(attr_flags)
    rows = [tuple(int(x) for x in flags[i]) for i in range(flags.shape[0])]
    return DecisionTable.build(attr_names, rows,
                               [int(bool(b)) for b in is_bottleneck],
                               entry_ids=list(region_ids))
