"""AutoAnalyzer driver (paper §3 end-to-end, §4 'data analysis').

Answers the paper's three questions fully automatically:
  1. Are there any bottlenecks?            (clustering / severity classes)
  2. Where are they?                       (CCCR search, external + internal)
  3. What are their root causes?           (rough-set core extraction)

Inputs are plain numpy matrices collected by ``repro.perfdbg`` (or synthetic
harnesses in tests/benchmarks):

  measurements                                  shape
  ------------------------------------------    --------
  cpu_time   (inclusive, per region/process)    (m, n)
  wall_time  (inclusive)                        (m, n)
  program_wall                                  (m,)
  cycles, instructions                          (m, n)

  attributes: {name: (m, n) matrix} used for root-cause tables.  The paper's
  canonical five are l1_miss_rate, l2_miss_rate, disk_io, network_io,
  instructions; the TPU adaptation feeds bytes/flop ratios, collective bytes,
  host-I/O bytes and HLO flops instead (see perfdbg.attributes).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .external import (COLLAPSE_AUTO, CollapseCertificate, ExternalReport,
                       cluster_collapsed)
from .internal import InternalReport, attribute_flags
from .regions import RegionTree
from .roughset import (CoreResult, DecisionTable, external_decision_table,
                       extract_core, internal_decision_table)
from .vectors import as_matrix

PAPER_ATTRIBUTES = ("l1_miss_rate", "l2_miss_rate", "disk_io", "network_io",
                    "instructions")


def fingerprint_arrays(*arrays, salt: str = "") -> bytes:
    """Content fingerprint of numpy arrays (dtype + shape + raw bytes).

    Drives the session's incremental window reuse: two windows whose
    matrices fingerprint equal carry bit-identical inputs, so the previous
    window's analysis results can be reused verbatim.  blake2b keeps the
    cost a small fraction of even a cache-hit window (~GB/s) while making
    a false match practically impossible.
    """
    h = hashlib.blake2b(salt.encode(), digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


@dataclasses.dataclass(frozen=True)
class Measurements:
    cpu_time: np.ndarray          # (m, n) inclusive CPU/device-busy time
    wall_time: np.ndarray         # (m, n) inclusive wall time
    program_wall: np.ndarray      # (m,)
    cycles: np.ndarray            # (m, n)
    instructions: np.ndarray      # (m, n)

    def __post_init__(self):
        m, n = as_matrix(self.cpu_time).shape
        for name in ("wall_time", "cycles", "instructions"):
            if as_matrix(getattr(self, name)).shape != (m, n):
                raise ValueError(f"{name} shape mismatch")
        if np.asarray(self.program_wall).shape != (m,):
            raise ValueError("program_wall must be (m,)")

    @property
    def n_processes(self) -> int:
        return as_matrix(self.cpu_time).shape[0]


@dataclasses.dataclass(frozen=True)
class RootCauseReport:
    table: DecisionTable
    core: CoreResult
    # per-bottleneck attribution: region/process -> attributes flagged for it
    per_entry: Tuple[Tuple[object, Tuple[str, ...]], ...]
    #: schema-declared semantic roles of the table's attributes
    #: ((attr name, role) pairs; see repro.core.roughset.ATTRIBUTE_ROLES).
    #: Consumers interpret cores through these — never through attribute
    #: names, which are whatever the collection schema happened to call its
    #: fields.  Empty when the ingesting caller declared no roles.
    roles: Tuple[Tuple[str, str], ...] = ()
    #: per-attribute exactness certificates of the collapse-accelerated
    #: clustering behind the decision table ((attr name, certificate)
    #: pairs, external tables only — the internal table is built from
    #: k-means flags, not OPTICS runs).  Every certificate's labels are
    #: exact: ``mode == "quantized"`` means the eps-margin check *proved*
    #: them equal to the uncollapsed clustering's, ``"exact"`` means the
    #: duplicate collapse (or plain path) produced them directly.
    certificates: Tuple[Tuple[str, Optional[CollapseCertificate]], ...] = ()

    def certificate_of(self, attr: str) -> Optional[CollapseCertificate]:
        """Collapse certificate of one attribute's clustering run."""
        for name, c in self.certificates:
            if name == attr:
                return c
        return None

    def role_of(self, attr: str) -> Optional[str]:
        """Declared role of one attribute (None when undeclared)."""
        for name, role in self.roles:
            if name == attr:
                return role
        return None

    def core_alternatives(self) -> Tuple[Tuple[str, ...], ...]:
        """Every minimal core the rough-set step found (ties preserved)."""
        return self.core.cores

    def render(self) -> str:
        lines = [self.core.render()]
        for eid, attrs in self.per_entry:
            if attrs:
                lines.append(f"  entry {eid}: " + ", ".join(attrs))
        return "\n".join(lines)


def _role_pairs(names: Sequence[str],
                roles: Optional[Mapping[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not roles:
        return ()
    return tuple((n, roles[n]) for n in names if n in roles)


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    external: ExternalReport
    internal: InternalReport
    external_root_causes: Optional[RootCauseReport]
    internal_root_causes: Optional[RootCauseReport]

    def render(self, tree: Optional[RegionTree] = None) -> str:
        parts = ["=== external bottlenecks ===", self.external.render(tree)]
        if self.external_root_causes:
            parts += ["external root causes:", self.external_root_causes.render()]
        parts += ["=== internal bottlenecks ===", self.internal.render(tree)]
        if self.internal_root_causes:
            parts += ["internal root causes:", self.internal_root_causes.render()]
        return "\n".join(parts)


def external_root_causes(tree: RegionTree, attrs: Mapping[str, np.ndarray],
                         ext: ExternalReport,
                         roles: Optional[Mapping[str, str]] = None,
                         collapse: str = COLLAPSE_AUTO
                         ) -> Optional[RootCauseReport]:
    """Rough-set root causes for external bottlenecks (paper §3.4.2).

    Per-attribute OPTICS clustering is restricted to the CCCR columns
    *before* any matrix is materialized: each attribute is sliced to the
    m x |cccr cols| submatrix and clustered one at a time (peak memory is
    one attribute's slice, never the n_attrs x m x n stack), through the
    same collapse-accelerated path as the CCR search
    (:func:`~repro.core.external.cluster_collapsed`): duplicate ranks
    collapse to weighted points, and under ``collapse="quantized"``/
    ``"auto"`` at pod scale the certified ball collapse engages with
    automatic exact fallback — the per-attribute certificates land on
    ``RootCauseReport.certificates``.  ``roles`` (attribute name ->
    semantic role, normally the collection schema's declaration) rides
    along on the report so downstream consumers never hardcode attribute
    names.
    """
    if not ext.exists or not ext.cccrs:
        return None
    names = tuple(attrs)
    region_ids = np.asarray(tree.ids())
    cols = np.flatnonzero(np.isin(region_ids, np.asarray(ext.cccrs)))
    m = len(ext.clustering.labels)
    ids = np.zeros((m, len(names)), dtype=np.int64)
    certs: list = []
    for a, n in enumerate(names):   # attrs may be empty: locate-only analysis
        sub = as_matrix(attrs[n])[:, cols]   # one attribute slice at a time
        res, cert = cluster_collapsed(sub, collapse=collapse)
        ids[:, a] = res.labels
        certs.append((n, cert))
    table = external_decision_table(names, ids, ext.clustering.labels)
    core = extract_core(table)
    # attribute each non-majority process to its flagged core attributes
    core_mask = np.asarray([n in core.core for n in names], dtype=bool)
    flagged = (ids != 0) & core_mask[None, :]
    per_entry = tuple((i, tuple(itertools.compress(names, flagged[i])))
                      for i in range(m))
    return RootCauseReport(table, core, per_entry, _role_pairs(names, roles),
                           certificates=tuple(certs))


def internal_root_causes(tree: RegionTree, attrs: Mapping[str, np.ndarray],
                         internal: InternalReport,
                         roles: Optional[Mapping[str, str]] = None
                         ) -> Optional[RootCauseReport]:
    """Rough-set root causes for internal bottlenecks (paper §3.4.3),
    vectorized over regions and attributes."""
    if not internal.cccrs:
        return None
    names = tuple(attrs)
    region_ids = tree.ids()
    flags = np.zeros((len(region_ids), len(names)), dtype=np.int64)
    if names:   # attrs may be empty: locate-only analysis
        means = np.stack([as_matrix(attrs[n]) for n in names]).mean(axis=1)
        flags = np.stack([attribute_flags(means[a])
                          for a in range(len(names))], axis=1)  # (n, na)
    # decision column: severity-classified bottlenecks (CCRs).  The
    # paper's own Table 3 marks region 14 (a CCR whose CCCR is its child
    # 11) with D=1, so the decision is CCR membership; CCCRs are the
    # *locations* reported to the user.
    is_b = np.isin(np.asarray(region_ids), np.asarray(internal.ccrs))
    table = internal_decision_table(names, flags, is_b.tolist(), region_ids)
    core = extract_core(table)
    core_mask = np.asarray([n in core.core for n in names], dtype=bool)
    flagged = (flags == 1) & core_mask[None, :]
    cccr_set = set(internal.cccrs)
    per_entry = tuple((rid, tuple(itertools.compress(names, flagged[r])))
                      for r, rid in enumerate(region_ids) if rid in cccr_set)
    return RootCauseReport(table, core, per_entry, _role_pairs(names, roles))


class AutoAnalyzer:
    """Single-window analyzer.  The driver logic lives in
    ``core.session.analyze_window``; this class validates inputs and is the
    convenient object API (``AutoAnalyzer(tree, meas, attrs).analyze()``)."""

    def __init__(self, tree: RegionTree, measurements: Measurements,
                 attributes: Mapping[str, np.ndarray],
                 attr_roles: Optional[Mapping[str, str]] = None):
        self.tree = tree
        self.meas = measurements
        self.attrs = {k: as_matrix(v) for k, v in attributes.items()}
        self.attr_roles = dict(attr_roles or {})
        m, n = as_matrix(measurements.cpu_time).shape
        for k, v in self.attrs.items():
            if v.shape != (m, n):
                raise ValueError(f"attribute {k} shape {v.shape} != {(m, n)}")

    def _external_root_causes(self, ext: ExternalReport) -> Optional[RootCauseReport]:
        return external_root_causes(self.tree, self.attrs, ext,
                                    roles=self.attr_roles)

    def _internal_root_causes(self, internal: InternalReport) -> Optional[RootCauseReport]:
        return internal_root_causes(self.tree, self.attrs, internal,
                                    roles=self.attr_roles)

    def analyze(self) -> AnalysisReport:
        from .session import analyze_window
        return analyze_window(self.tree, self.meas, self.attrs,
                              roles=self.attr_roles)


def analyze(tree: RegionTree, measurements: Measurements,
            attributes: Mapping[str, np.ndarray],
            attr_roles: Optional[Mapping[str, str]] = None) -> AnalysisReport:
    """One-shot analysis — a single-window :class:`AnalysisSession`."""
    from .session import AnalysisSession
    return AnalysisSession(tree).ingest(measurements, attributes,
                                        attr_roles=attr_roles).report
