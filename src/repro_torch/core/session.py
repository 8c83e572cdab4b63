"""Streaming analysis sessions: AutoAnalyzer over successive windows
(core layer: pure numpy over frozen snapshots; no jax, no transport).

The paper runs its locate -> root-cause pipeline once, over a whole run.
For continuous (production) analysis we instead consume *windows* of a live
run — each window is one ``WindowSnapshot`` from a windowed
``RegionRecorder`` (or raw measurement/attribute matrices) — and track how
bottlenecks evolve: appearing, disappearing, or migrating between regions.

``analyze_window`` is the single-window driver (external clustering + CCCR
search, CRNM + internal CCCR search, rough-set root causes);
``core.analyzer.AutoAnalyzer.analyze`` is a thin call into it.
``AnalysisSession.ingest*`` runs it per window, caches the per-window
reports (clustering results and decision tables ride along inside them), and
diffs each window against the previous one.  ``report()`` returns the
cross-window :class:`SessionReport` timeline.

Incremental reuse: consecutive windows of a steady workload often carry the
*identical* matrices (the paper's Step 2 ``same_output`` observation, and
exactly what ``--sim-ranks`` style pod simulations produce).  The session
fingerprints each window's inputs (:func:`~repro.core.analyzer.
fingerprint_arrays`) and reuses the previous window's external clustering /
CCR search, severity classification, and rough-set tables for every stage
whose inputs are unchanged.  Analysis is deterministic, so a cache hit
returns the same frozen report object recomputation would rebuild —
``SessionReport.render()`` is byte-identical with reuse on or off, and
the stages reused are recorded on ``WindowEntry.cache_hits`` /
``SessionReport.cache_hit_counts()`` so the savings are observable without
perturbing policy evidence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from .analyzer import (AnalysisReport, Measurements, RootCauseReport,
                       external_root_causes, fingerprint_arrays,
                       internal_root_causes)
from .diagnosis import (Diagnosis, DiagnosisStrategy, RoughSetStrategy,
                        WindowFeatures, window_features)
from .external import COLLAPSE_AUTO, COLLAPSE_EXACT, COLLAPSE_MODES, \
    analyze_external
from .internal import InternalReport, analyze_internal, crnm
from .kmeans import KMeansResult
from .regions import RegionTree
from .roughset import DecisionTable
from .vectors import as_matrix

#: Cache stages a window can reuse from its predecessor (WindowEntry.cache_hits
#: values).  "internal_gated" marks a window whose internal pass was skipped
#: by the external gate, not reused from cache.
CACHE_STAGES = ("external", "external_root_causes", "internal",
                "internal_root_causes", "internal_gated")


def _checked_attrs(measurements: Measurements,
                   attributes: Mapping[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
    attrs = {k: as_matrix(v) for k, v in attributes.items()}
    m, n = as_matrix(measurements.cpu_time).shape
    for k, v in attrs.items():
        if v.shape != (m, n):
            raise ValueError(f"attribute {k} shape {v.shape} != {(m, n)}")
    return attrs


def analyze_window(tree: RegionTree, measurements: Measurements,
                   attributes: Mapping[str, np.ndarray],
                   roles: Optional[Mapping[str, str]] = None,
                   collapse: str = COLLAPSE_AUTO,
                   column_workers: int = 1) -> AnalysisReport:
    """The paper's full single-window pipeline (§4 driver).  ``roles`` is
    the collection schema's attribute-role declaration, recorded on the
    root-cause reports for name-free interpretation of cores."""
    report, _, _ = _analyze_window_cached(tree, measurements, attributes,
                                          memo=None, internal_gate_s=None,
                                          keep_memo=False, roles=roles,
                                          collapse=collapse,
                                          column_workers=column_workers)
    return report


def _strategy_salt(strategy: Optional[DiagnosisStrategy]) -> str:
    return getattr(strategy, "name", "") if strategy is not None else ""


@dataclasses.dataclass(frozen=True)
class _WindowMemo:
    """Input fingerprints + report of the previously analyzed window."""
    fp_cpu: bytes              # cpu_time matrix (external stage input)
    fp_internal: bytes         # wall/program_wall/cycles/instructions
    fp_attrs: bytes            # attribute name -> matrix mapping
    internal_gated: bool       # report.internal is the gate's empty stub
    report: AnalysisReport


def _fingerprint_attrs(attrs: Mapping[str, np.ndarray],
                       roles: Optional[Mapping[str, str]],
                       collapse: str) -> bytes:
    names = sorted(attrs)
    salt = "\x00".join(names)
    if roles:
        # roles land on the cached RootCauseReports, so a role change must
        # miss the memo even when the matrices are bit-identical
        salt += "\x01" + "\x00".join(f"{k}={roles[k]}" for k in sorted(roles))
    # the collapse mode rides on the root-cause reports too (per-attribute
    # certificates), so a memo taken under one mode never replays under
    # another
    salt += f"\x02collapse={collapse}"
    return fingerprint_arrays(*(attrs[k] for k in names), salt=salt)


def _gated_internal(tree: RegionTree) -> InternalReport:
    """Empty internal report for a window the external gate disposed of
    (single cluster, S below threshold): no severity classes, no CCCRs."""
    return InternalReport(crnm_mean=(), severity=KMeansResult((), ()),
                          ccrs=(), cccrs=(), region_ids=tree.ids())


def _gate_needs_exact(ext, internal_gate_s: Optional[float]) -> bool:
    """True when the collapsed severity's certified interval straddles the
    internal gate: the reported S is a lower bound within
    ``certificate.severity_bound`` of the exact value, so a gate inside
    that interval could be decided differently by the exact path — re-run
    exactly rather than let the approximation flip a gating decision."""
    return (internal_gate_s is not None and not ext.exists
            and ext.certificate is not None
            and ext.certificate.severity_bound > 0.0
            and ext.severity < internal_gate_s
            <= ext.severity + ext.certificate.severity_bound)


def _analyze_window_cached(tree: RegionTree, measurements: Measurements,
                           attributes: Mapping[str, np.ndarray],
                           memo: Optional[_WindowMemo],
                           internal_gate_s: Optional[float],
                           keep_memo: bool = True,
                           roles: Optional[Mapping[str, str]] = None,
                           collapse: str = COLLAPSE_AUTO,
                           column_workers: int = 1,
                           strategy_salt: str = ""
                           ) -> Tuple[AnalysisReport, Tuple[str, ...],
                                      Optional[_WindowMemo]]:
    """Single-window pipeline with stage-level reuse against ``memo``.

    Every stage whose exact inputs match the previous window's fingerprints
    reuses the previous frozen result; analysis is deterministic, so the
    report is identical to an uncached run.  Returns
    ``(report, cache_hits, new_memo)``; with ``keep_memo=False`` (one-shot
    callers, reuse disabled) the input hashing is skipped entirely and
    ``new_memo`` is None.
    """
    attrs = _checked_attrs(measurements, attributes)
    if memo is not None or keep_memo:
        # the collapse mode changes the external report (certified severity
        # bound vs exact severity), so it salts the external fingerprint —
        # a memo taken under one mode can never be replayed under another;
        # the diagnosis strategy name salts it for the same reason (a memo
        # taken under one strategy must never seed reuse under another)
        salt = f"collapse={collapse}"
        if strategy_salt:
            salt += f"\x00strategy={strategy_salt}"
        fp_cpu = fingerprint_arrays(measurements.cpu_time, salt=salt)
        fp_internal = fingerprint_arrays(
            measurements.wall_time, measurements.program_wall,
            measurements.cycles, measurements.instructions)
        fp_attrs = _fingerprint_attrs(attrs, roles, collapse)
    else:
        fp_cpu = fp_internal = fp_attrs = b""
    hits: List[str] = []

    if memo is not None and fp_cpu == memo.fp_cpu:
        ext = memo.report.external
        hits.append("external")
        if fp_attrs == memo.fp_attrs:
            ext_rc = memo.report.external_root_causes
            hits.append("external_root_causes")
        else:
            ext_rc = external_root_causes(tree, attrs, ext, roles=roles,
                                          collapse=collapse)
    else:
        ext = analyze_external(tree, measurements.cpu_time,
                               collapse=collapse,
                               column_workers=column_workers)
        if _gate_needs_exact(ext, internal_gate_s):
            ext = analyze_external(tree, measurements.cpu_time,
                                   collapse=COLLAPSE_EXACT,
                                   column_workers=column_workers)
        ext_rc = external_root_causes(tree, attrs, ext, roles=roles,
                                      collapse=collapse)

    gated = (internal_gate_s is not None and not ext.exists
             and ext.severity < internal_gate_s)
    if gated:
        internal = _gated_internal(tree)
        int_rc: Optional[RootCauseReport] = None
        hits.append("internal_gated")
    elif (memo is not None and fp_internal == memo.fp_internal
            and not memo.internal_gated):
        internal = memo.report.internal
        hits.append("internal")
        if fp_attrs == memo.fp_attrs:
            int_rc = memo.report.internal_root_causes
            hits.append("internal_root_causes")
        else:
            int_rc = internal_root_causes(tree, attrs, internal, roles=roles)
    else:
        cm = crnm(measurements.wall_time, measurements.program_wall,
                  measurements.cycles, measurements.instructions)
        internal = analyze_internal(tree, cm)
        int_rc = internal_root_causes(tree, attrs, internal, roles=roles)

    report = AnalysisReport(external=ext, internal=internal,
                            external_root_causes=ext_rc,
                            internal_root_causes=int_rc)
    new_memo = _WindowMemo(fp_cpu, fp_internal, fp_attrs, gated, report) \
        if keep_memo else None
    return report, tuple(hits), new_memo


@dataclasses.dataclass(frozen=True)
class WindowDiff:
    """Internal/external bottleneck churn between consecutive windows.
    ``migrated`` pairs a region that vanished with one that appeared in the
    same step — the usual signature of a bottleneck moving (e.g. after a fix
    shifts pressure to a sibling phase)."""

    appeared: Tuple[int, ...]              # internal CCCRs new this window
    disappeared: Tuple[int, ...]           # internal CCCRs gone this window
    persisted: Tuple[int, ...]             # internal CCCRs in both
    external_appeared: Tuple[int, ...]
    external_disappeared: Tuple[int, ...]
    severity_delta: float                  # change in the external S metric
    migrated: Tuple[Tuple[int, int], ...]  # (from_rid, to_rid) heuristic pairs

    @property
    def changed(self) -> bool:
        return bool(self.appeared or self.disappeared or
                    self.external_appeared or self.external_disappeared)


def diff_reports(prev: Optional[AnalysisReport],
                 cur: AnalysisReport) -> WindowDiff:
    prev_int = set(prev.internal.cccrs) if prev else set()
    prev_ext = set(prev.external.cccrs) if prev else set()
    cur_int, cur_ext = set(cur.internal.cccrs), set(cur.external.cccrs)
    appeared = tuple(sorted(cur_int - prev_int))
    disappeared = tuple(sorted(prev_int - cur_int))
    prev_s = prev.external.severity if prev else 0.0
    migrated = tuple(zip(disappeared, appeared))
    return WindowDiff(
        appeared=appeared, disappeared=disappeared,
        persisted=tuple(sorted(cur_int & prev_int)),
        external_appeared=tuple(sorted(cur_ext - prev_ext)),
        external_disappeared=tuple(sorted(prev_ext - cur_ext)),
        severity_delta=float(cur.external.severity - prev_s),
        migrated=migrated)


@dataclasses.dataclass(frozen=True)
class WindowEntry:
    """One analyzed window: the full report (with its clustering result and
    rough-set decision tables cached inside) plus the diff vs the previous
    window.

    ``gap_ranks`` and ``rank_cpu`` ride along from the snapshot so downstream
    consumers (straggler detection, ``core.policy`` engines) never need the
    raw matrices back: ``gap_ranks`` are ranks the merged pod view had no
    shard for (zero-filled rows), ``rank_cpu`` is each rank's total region
    CPU time this window.

    The verdict accessors below are the *stable keys policies observe*:
    their names and semantics are part of the public API
    (see ``docs/policies.md``).

    ``cache_hits`` lists the analysis stages reused from the previous
    window's memo (values from :data:`CACHE_STAGES`); it is bookkeeping
    only — a reused stage holds the identical frozen objects recomputation
    would produce, so policy evidence is unaffected.

    ``features`` is the normalized :class:`~repro.core.diagnosis.
    WindowFeatures` vector extracted from the raw matrices (the
    threshold/learned strategies' input); ``diagnosis`` is the session
    strategy's verdict.  Both are additive: ``SessionReport.render()``
    does not consume them, so reports stay byte-identical to pre-strategy
    sessions.

    A **tombstone** (``failed=True``) marks a window whose analysis raised
    under supervision: ``report`` is ``None``, ``error`` records the
    exception as evidence, and the entry holds the window's place in the
    timeline (indices keep counting) without feeding policies or diffs.
    The verdict accessors must not be called on a tombstone — policy
    engines and straggler timelines skip ``failed`` entries."""

    index: int
    label: Optional[str]
    report: Optional[AnalysisReport]
    diff: WindowDiff
    gap_ranks: Tuple[int, ...] = ()
    rank_cpu: Tuple[float, ...] = ()
    cache_hits: Tuple[str, ...] = ()
    features: Optional[WindowFeatures] = None
    diagnosis: Optional[Diagnosis] = None
    failed: bool = False
    error: Optional[str] = None

    @property
    def clustering(self):
        return self.report.external.clustering

    @property
    def decision_tables(self) -> Dict[str, DecisionTable]:
        out: Dict[str, DecisionTable] = {}
        if self.report.external_root_causes:
            out["external"] = self.report.external_root_causes.table
        if self.report.internal_root_causes:
            out["internal"] = self.report.internal_root_causes.table
        return out

    def title(self) -> str:
        return self.label or f"window {self.index}"

    # -- stable verdict accessors (the policy-facing surface) ---------------
    @property
    def severity(self) -> float:
        """The paper's external dissimilarity metric S for this window."""
        return float(self.report.external.severity)

    def straggler_verdict(self):
        """Gap-aware :class:`repro.perfdbg.straggler.StragglerVerdict` for
        this window (a masked rank is *missing*, never a fast outlier)."""
        from repro_torch.perfdbg.straggler import detect   # lazy: avoids cycle
        return detect(self.report, gap_ranks=self.gap_ranks)

    def core_attributes(self, which: str = "external") -> Tuple[str, ...]:
        """The rough-set core for ``which`` ("external" or "internal") —
        the attribute names the decision table cannot discern bottlenecks
        without; ``()`` when that analysis found no bottleneck."""
        rc = self._root_causes(which)
        return rc.core.core if rc is not None else ()

    def core_alternatives(self, which: str = "external"
                          ) -> Tuple[Tuple[str, ...], ...]:
        """Every minimal rough-set core for ``which`` (ties preserved —
        ``core_attributes`` is the first alternative).  An attribute
        appearing in *some* minimal core suffices on its own to discern
        the bottleneck, which is the question role-driven policies ask."""
        rc = self._root_causes(which)
        return rc.core_alternatives() if rc is not None else ()

    def role_of(self, attr: str, which: str = "external") -> Optional[str]:
        """Schema-declared semantic role of ``attr`` (see
        ``repro.core.roughset.ATTRIBUTE_ROLES``); ``None`` when the
        ingesting snapshot declared none.  Policies interpret cores through
        roles, never through schema-specific attribute names."""
        rc = self._root_causes(which)
        return rc.role_of(attr) if rc is not None else None

    def _root_causes(self, which: str):
        return (self.report.external_root_causes if which == "external"
                else self.report.internal_root_causes)


@dataclasses.dataclass(frozen=True)
class SessionReport:
    """Cross-window timeline of a streaming analysis session."""

    windows: Tuple[WindowEntry, ...]

    def bottleneck_timeline(self) -> Dict[int, Tuple[int, ...]]:
        """region id -> indices of windows where it was an internal CCCR.
        Failed (tombstoned) windows carry no report and are skipped."""
        out: Dict[int, List[int]] = {}
        for w in self.windows:
            if w.failed:
                continue
            for rid in w.report.internal.cccrs:
                out.setdefault(rid, []).append(w.index)
        return {rid: tuple(ws) for rid, ws in out.items()}

    def failed_count(self) -> int:
        """Windows tombstoned by supervised failure containment."""
        return sum(1 for w in self.windows if w.failed)

    def first_window(self, rid: int) -> Optional[int]:
        """First window in which ``rid`` was flagged as an internal CCCR."""
        tl = self.bottleneck_timeline().get(rid)
        return tl[0] if tl else None

    def cache_hit_counts(self) -> Dict[str, int]:
        """stage name -> number of windows that reused it (see
        :data:`CACHE_STAGES`); empty when incremental reuse never fired.
        Purely observational — reports are identical with caching off."""
        out: Dict[str, int] = {}
        for w in self.windows:
            for stage in w.cache_hits:
                out[stage] = out.get(stage, 0) + 1
        return out

    def render(self, tree: Optional[RegionTree] = None) -> str:
        nm = (lambda r: tree.name(r)) if tree is not None else (lambda r: f"region {r}")
        lines = [f"=== analysis session: {len(self.windows)} window(s) ==="]
        for w in self.windows:
            if w.failed:
                lines.append(f"[{w.title()}] FAILED: {w.error or 'analysis error'}")
                continue
            ints = ", ".join(nm(r) for r in w.report.internal.cccrs) or "(none)"
            exts = ", ".join(nm(r) for r in w.report.external.cccrs)
            line = (f"[{w.title()}] S={w.report.external.severity:.4f} "
                    f"internal: {ints}")
            if exts:
                line += f" external: {exts}"
            marks = []
            if w.diff.appeared:
                marks.append("appeared: " + ", ".join(nm(r) for r in w.diff.appeared))
            if w.diff.disappeared:
                marks.append("disappeared: " + ", ".join(nm(r) for r in w.diff.disappeared))
            if w.diff.migrated:
                marks.append("migrated: " + ", ".join(
                    f"{nm(a)}->{nm(b)}" for a, b in w.diff.migrated))
            if marks:
                line += "  [" + "; ".join(marks) + "]"
            lines.append(line)
        tl = self.bottleneck_timeline()
        if tl:
            lines.append("timeline: " + "; ".join(
                f"{nm(rid)} in windows {list(ws)}" for rid, ws in sorted(tl.items())))
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class PreparedWindow:
    """Output of :meth:`AnalysisSession.prepare` — one fully analyzed
    window, not yet appended to any timeline.  Carries everything
    :meth:`AnalysisSession.ingest_prepared` needs to assemble the entry
    in submission order: the frozen report, the reuse bookkeeping, and the
    snapshot-derived policy surface (``gap_ranks``/``rank_cpu``)."""

    label: Optional[str]
    report: AnalysisReport
    cache_hits: Tuple[str, ...]
    gap_ranks: Tuple[int, ...]
    rank_cpu: Tuple[float, ...]
    memo: Optional[_WindowMemo]
    features: Optional[WindowFeatures] = None


class AnalysisSession:
    """Consumes successive window snapshots of a live run and maintains the
    per-window reports + cross-window diffs.  ``keep_windows`` bounds memory
    for long sessions (oldest entries are dropped; indices keep counting).

    Invariants: windows are analyzed in ingestion order and entry indices
    are assigned monotonically from 0; analysis is deterministic, so two
    sessions fed the same snapshot stream produce byte-identical
    ``report().render()`` output (this is what lets the async pipeline and
    any attached policy engine mirror the synchronous path exactly) —
    including with incremental ``reuse``, which only ever substitutes a
    previous window's frozen results for stages whose fingerprinted inputs
    are unchanged.  Not thread-safe — one ingesting thread per session.

    ``internal_gate_s`` (off by default) skips the internal pass entirely
    for windows the external gate already disposes of — a single cluster
    with severity ``S`` below the threshold; such windows carry an empty
    internal report and are marked ``internal_gated`` in ``cache_hits``.
    Enabling the gate changes reports (internal CCCRs are not computed for
    healthy windows), so it is an explicit opt-in for high-rate pods.

    ``strategy`` is the attached :class:`~repro.core.diagnosis.
    DiagnosisStrategy` (default :class:`~repro.core.diagnosis.
    RoughSetStrategy` — the paper's path, observably identical to having
    no strategy at all); each assembled entry carries its verdict on
    ``WindowEntry.diagnosis``.  The strategy name is salted into the reuse
    fingerprints, so memos never cross strategies."""

    def __init__(self, tree: RegionTree, keep_windows: Optional[int] = None,
                 *, reuse: bool = True,
                 internal_gate_s: Optional[float] = None,
                 collapse: str = COLLAPSE_AUTO, column_workers: int = 1,
                 strategy: Optional[DiagnosisStrategy] = None):
        if collapse not in COLLAPSE_MODES:
            raise ValueError(f"collapse must be one of {COLLAPSE_MODES}, "
                             f"got {collapse!r}")
        if strategy is None:
            strategy = RoughSetStrategy()
        if not callable(getattr(strategy, "diagnose", None)):
            raise TypeError(f"strategy {strategy!r} does not implement "
                            "diagnose(entry)")
        self.tree = tree
        self.keep_windows = keep_windows
        self.reuse = reuse
        self.internal_gate_s = internal_gate_s
        self.collapse = collapse
        self.column_workers = column_workers
        self.strategy = strategy
        self._memo: Optional[_WindowMemo] = None
        self._entries: List[WindowEntry] = []
        self._next_index = 0
        # last successfully analyzed report: diffs skip over tombstones, so
        # on clean input this is always the previous entry's report and
        # behavior is unchanged
        self._last_report: Optional[AnalysisReport] = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def latest(self) -> Optional[WindowEntry]:
        return self._entries[-1] if self._entries else None

    @property
    def windows(self) -> Tuple[WindowEntry, ...]:
        return tuple(self._entries)

    # -- ingestion -----------------------------------------------------------
    def prepare(self, measurements: Measurements,
                attributes: Mapping[str, np.ndarray],
                label: Optional[str] = None,
                gap_ranks: Tuple[int, ...] = (),
                attr_roles: Optional[Mapping[str, str]] = None,
                memo: Optional[_WindowMemo] = None) -> "PreparedWindow":
        """Stage 1 of ``ingest``: the full single-window analysis, touching
        no mutable session state — safe to run from several threads at once
        (the async pool's sharding unit).  ``memo`` is the predecessor memo
        to attempt stage reuse against; pool workers pass the latest
        *assembled* memo, which may lag the true predecessor — any memo is
        correct (reuse only ever substitutes results for fingerprint-equal
        inputs), a stale one just scores fewer hits.  Ignored when the
        session was built with ``reuse=False``."""
        report, hits, new_memo = _analyze_window_cached(
            self.tree, measurements, attributes,
            memo=memo if self.reuse else None,
            internal_gate_s=self.internal_gate_s, keep_memo=self.reuse,
            roles=attr_roles, collapse=self.collapse,
            column_workers=self.column_workers,
            strategy_salt=_strategy_salt(self.strategy))
        rank_cpu = tuple(float(x) for x in
                         as_matrix(measurements.cpu_time).sum(axis=1))
        # extracted here, while the raw matrices are still in hand — the
        # assembled entry carries only the frozen report
        features = window_features(self.tree, measurements, attributes,
                                   roles=attr_roles, gap_ranks=gap_ranks)
        return PreparedWindow(label=label, report=report, cache_hits=hits,
                              gap_ranks=tuple(int(r) for r in gap_ranks),
                              rank_cpu=rank_cpu, memo=new_memo,
                              features=features)

    def prepare_snapshot(self, snap, label: Optional[str] = None,
                         memo: Optional[_WindowMemo] = None
                         ) -> "PreparedWindow":
        """:meth:`prepare` for a ``perfdbg.recorder.WindowSnapshot`` (the
        thread-safe half of :meth:`ingest_snapshot`)."""
        mask = getattr(snap, "gap_mask", None)
        gaps = tuple(int(r) for r in np.flatnonzero(mask)) \
            if mask is not None else ()
        roles_fn = getattr(snap, "attribute_roles", None)
        return self.prepare(snap.measurements(), snap.attributes(),
                            label=label or snap.label, gap_ranks=gaps,
                            attr_roles=roles_fn() if roles_fn else None,
                            memo=memo)

    def ingest_prepared(self, prepared: "PreparedWindow") -> WindowEntry:
        """Stage 2 of ``ingest``: append a prepared window to the timeline
        (diff vs the previous entry, index assignment, memo update).  Must
        be called from one thread at a time, in submission order — this is
        the in-order assembly step the async pool serializes."""
        if self.reuse:
            self._memo = prepared.memo
        prev = self._last_report
        entry = WindowEntry(self._next_index, prepared.label, prepared.report,
                            diff_reports(prev, prepared.report),
                            gap_ranks=prepared.gap_ranks,
                            rank_cpu=prepared.rank_cpu,
                            cache_hits=prepared.cache_hits,
                            features=prepared.features)
        entry = dataclasses.replace(entry,
                                    diagnosis=self.strategy.diagnose(entry))
        self._last_report = prepared.report
        return self._append(entry)

    def ingest_failure(self, label: Optional[str] = None,
                       error: Optional[str] = None) -> WindowEntry:
        """Tombstone one window whose analysis raised: the entry takes its
        place in the timeline (``failed=True``, exception text on
        ``error``) but carries no report, feeds no diff (the next good
        window diffs against the last good one), and gets no diagnosis.
        This is the supervised pipeline's containment primitive."""
        empty = WindowDiff(appeared=(), disappeared=(), persisted=(),
                           external_appeared=(), external_disappeared=(),
                           severity_delta=0.0, migrated=())
        return self._append(WindowEntry(self._next_index, label, None, empty,
                                        failed=True, error=error))

    def _append(self, entry: WindowEntry) -> WindowEntry:
        self._next_index += 1
        self._entries.append(entry)
        if self.keep_windows is not None and len(self._entries) > self.keep_windows:
            del self._entries[:len(self._entries) - self.keep_windows]
        return entry

    @property
    def latest_memo(self) -> Optional[_WindowMemo]:
        """The memo of the most recently assembled window (``None`` before
        the first window or with ``reuse=False``) — what concurrent
        preparers should pass to :meth:`prepare`."""
        return self._memo

    def ingest(self, measurements: Measurements,
               attributes: Mapping[str, np.ndarray],
               label: Optional[str] = None,
               gap_ranks: Tuple[int, ...] = (),
               attr_roles: Optional[Mapping[str, str]] = None) -> WindowEntry:
        """Analyze one window of raw matrices and append it to the timeline.
        ``gap_ranks`` marks ranks whose rows are zero-filled placeholders
        (missing hosts in a merged pod view).  ``attr_roles`` is the
        schema's attribute-name -> semantic-role declaration (snapshots
        supply it automatically via ``ingest_snapshot``)."""
        return self.ingest_prepared(self.prepare(
            measurements, attributes, label=label, gap_ranks=gap_ranks,
            attr_roles=attr_roles, memo=self._memo))

    def ingest_snapshot(self, snap, label: Optional[str] = None) -> WindowEntry:
        """Analyze a ``perfdbg.recorder.WindowSnapshot``; the snapshot's
        ``gap_mask`` (merged pod views) becomes the entry's ``gap_ranks``
        and its schema's declared attribute roles ride along onto the
        root-cause reports."""
        mask = getattr(snap, "gap_mask", None)
        gaps = tuple(int(r) for r in np.flatnonzero(mask)) \
            if mask is not None else ()
        roles_fn = getattr(snap, "attribute_roles", None)
        return self.ingest(snap.measurements(), snap.attributes(),
                           label=label or snap.label, gap_ranks=gaps,
                           attr_roles=roles_fn() if roles_fn else None)

    def ingest_recorder(self, recorder, label: Optional[str] = None
                        ) -> WindowEntry:
        """Freeze the recorder's live window, reset it, and analyze it —
        the one-call streaming step for training/serving loops."""
        return self.ingest_snapshot(recorder.reset_window(), label=label)

    # -- reporting -----------------------------------------------------------
    def report(self) -> SessionReport:
        return SessionReport(tuple(self._entries))
