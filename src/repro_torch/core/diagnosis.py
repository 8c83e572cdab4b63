"""Pluggable diagnosis strategies over analyzed windows (core layer: pure
numpy over frozen reports; no jax at import time, no transport).

The paper's rough-set root-cause step (§3.4) is one way to turn a window's
clustering verdicts into a *diagnosis* — the follow-up journal version
(arXiv:1103.6087) explicitly frames root-cause uncovering as interchangeable
analyses.  This module makes that pluggable: a :class:`DiagnosisStrategy`
consumes one analyzed :class:`~repro.core.session.WindowEntry` and returns a
:class:`Diagnosis` — the bottleneck *kind* (a small cross-schema vocabulary),
the target region/rank sets, a confidence, and the evidence attributes.

Three strategies ship built in:

* :class:`RoughSetStrategy` — the paper's path, reading the window's
  rough-set cores through the schema-declared attribute roles.  This is the
  default: attaching it changes nothing observable (``SessionReport.render``
  and policy decisions are byte-identical to the pre-strategy code).
* :class:`ThresholdStrategy` — calibrated per-role cutoffs over the
  normalized :class:`WindowFeatures` vector (cf. the related repo's
  ``scripts/calibrate_thresholds.py``); no clustering, no rough sets.
* :class:`LearnedStrategy` — a small trained softmax classifier over the
  same feature vector (numpy inference; training lives in
  ``repro.perfdbg.corpus.fit_learned`` and uses jax when available).

Kinds map onto the schema role vocabulary
(:data:`repro.core.roughset.ATTRIBUTE_ROLES`): an *external* core naming a
work-role attribute means processes were handed different amounts of work
(``data_skew`` — repartition); network/io/memory-role cores name their
resource; a discernibility table that cannot separate the clusters by any
attribute is a pure speed difference (``compute`` — a slow/throttled host).
An *internal*-only bottleneck with a work core is a compute-heavy region
(``compute``), deliberately not ``data_skew`` — see ``ReshardPolicy``.

Strategies never mutate the session; the session runs the attached strategy
once per ingested window and stamps the result on ``WindowEntry.diagnosis``.
The strategy name is salted into the session's incremental-reuse
fingerprints so a memo taken under one strategy is never replayed under
another.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .roughset import (ATTRIBUTE_ROLES, ROLE_IO, ROLE_MEMORY, ROLE_NETWORK,
                       ROLE_WORK)
from .vectors import as_matrix

# ---------------------------------------------------------------------------
# Kind vocabulary
# ---------------------------------------------------------------------------

KIND_NONE = "none"            # no bottleneck this window
KIND_COMPUTE = "compute"      # pure speed difference / compute-heavy region
KIND_NETWORK = "network"      # communication volume
KIND_IO = "io"                # host/disk I/O volume
KIND_MEMORY = "memory"        # memory-hierarchy boundedness
KIND_DATA_SKEW = "data_skew"  # work imbalance: the partition is skewed

#: The full kind vocabulary, in the canonical (classifier class) order.
DIAGNOSIS_KINDS = (KIND_NONE, KIND_COMPUTE, KIND_NETWORK, KIND_IO,
                   KIND_MEMORY, KIND_DATA_SKEW)

#: Reading an *external* (inter-process) core through roles: a work-role
#: attribute discerning the clusters means the processes were handed
#: different work — data skew.  Internally (per-region) a work core merely
#: says the region is compute-heavy.
EXTERNAL_ROLE_KIND = {ROLE_WORK: KIND_DATA_SKEW, ROLE_NETWORK: KIND_NETWORK,
                      ROLE_IO: KIND_IO, ROLE_MEMORY: KIND_MEMORY}
INTERNAL_ROLE_KIND = {ROLE_WORK: KIND_COMPUTE, ROLE_NETWORK: KIND_NETWORK,
                      ROLE_IO: KIND_IO, ROLE_MEMORY: KIND_MEMORY}

#: Role fallback for streams whose schema declared no roles: the paper's
#: five attribute names (the same fallback ``ReshardPolicy`` applies for its
#: work attribute).
FALLBACK_ROLES = {
    "instructions": ROLE_WORK,
    "network_io": ROLE_NETWORK,
    "disk_io": ROLE_IO,
    "l1_miss_rate": ROLE_MEMORY,
    "l2_miss_rate": ROLE_MEMORY,
}


@dataclasses.dataclass(frozen=True)
class Diagnosis:
    """One strategy's verdict about one analyzed window.

    ``regions`` / ``ranks`` are the *targets*: the region ids the bottleneck
    lives in and the rank ids it singles out (empty when not localized —
    e.g. an internal-only bottleneck has no rank set, a pod-wide data skew
    has every region).  ``evidence`` is ``(attribute-or-feature, role)``
    pairs backing the kind.  ``scope`` records which analysis produced the
    verdict (``external`` / ``internal`` / ``none``)."""

    kind: str
    regions: Tuple[int, ...]
    ranks: Tuple[int, ...]
    confidence: float
    evidence: Tuple[Tuple[str, Optional[str]], ...]
    strategy: str
    scope: str = "none"

    def __post_init__(self):
        if self.kind not in DIAGNOSIS_KINDS:
            raise ValueError(f"unknown diagnosis kind {self.kind!r} "
                             f"(known: {DIAGNOSIS_KINDS})")

    def render(self) -> str:
        bits = [f"{self.kind} ({self.strategy}, conf {self.confidence:.2f})"]
        if self.regions:
            bits.append("regions " + ",".join(str(r) for r in self.regions))
        if self.ranks:
            bits.append("ranks " + ",".join(str(r) for r in self.ranks))
        if self.evidence:
            bits.append("evidence " + ",".join(a for a, _ in self.evidence))
        return " ".join(bits)


class DiagnosisStrategy:
    """Protocol for diagnosis back-ends.

    Subclasses set ``name`` (unique; salted into the session's reuse
    fingerprints) and implement ``diagnose``.  ``diagnose`` must be pure
    over the entry (the session may call it from any worker thread) and
    must not mutate the session or the entry."""

    name = "strategy"

    def diagnose(self, entry) -> Diagnosis:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Window features (the threshold/learned strategies' input)
# ---------------------------------------------------------------------------

#: Fixed feature vector layout, in order.  All entries are scale-free
#: (imbalance = (max - mean) / mean over present ranks), so the same cutoffs
#: and model weights apply across workload magnitudes.
FEATURE_NAMES = ("cpu_imbalance", "cpu_cv", "gap_fraction") + tuple(
    f"{role}_imbalance" for role in ATTRIBUTE_ROLES)

_TINY = 1e-12


@dataclasses.dataclass(frozen=True)
class WindowFeatures:
    """Normalized per-window feature vector plus the localization surface.

    ``values`` follows :data:`FEATURE_NAMES`.  ``region_imbalance`` is the
    per-region cross-rank CPU imbalance (localization score — the injected
    or emergent bottleneck region is the argmax); ``rank_scores`` is each
    rank's total CPU relative to the present-rank mean (gap-masked ranks
    score 0 — a missing host is never a straggler)."""

    names: Tuple[str, ...]
    values: Tuple[float, ...]
    region_ids: Tuple[int, ...]
    region_imbalance: Tuple[float, ...]
    rank_scores: Tuple[float, ...]

    def get(self, name: str) -> float:
        return self.values[self.names.index(name)]

    def as_dict(self) -> Dict[str, float]:
        return dict(zip(self.names, self.values))

    def vector(self) -> np.ndarray:
        return np.asarray(self.values, dtype=np.float64)


def _imbalance(v: np.ndarray) -> float:
    mean = float(v.mean()) if v.size else 0.0
    if v.size == 0:
        return 0.0
    return float((v.max() - mean) / max(abs(mean), _TINY))


def window_features(tree, measurements, attributes: Mapping[str, np.ndarray],
                    roles: Optional[Mapping[str, str]] = None,
                    gap_ranks: Sequence[int] = ()) -> WindowFeatures:
    """Extract the fixed :data:`FEATURE_NAMES` vector from one window's raw
    matrices.  Gap-masked ranks (zero-filled rows of a merged pod view) are
    excluded from every statistic; role resolution falls back to the
    paper's attribute names (:data:`FALLBACK_ROLES`) for role-less streams."""
    cpu = as_matrix(measurements.cpu_time)
    m, _ = cpu.shape
    present = np.ones(m, dtype=bool)
    gaps = sorted({int(r) for r in gap_ranks if 0 <= int(r) < m})
    present[gaps] = False
    totals = cpu.sum(axis=1)
    pt = totals[present]
    mean = float(pt.mean()) if pt.size else 0.0
    cpu_imb = _imbalance(pt)
    cpu_cv = float(pt.std() / max(abs(mean), _TINY)) if pt.size else 0.0
    rank_scores = np.where(present, totals / max(abs(mean), _TINY), 0.0)
    region_imb = tuple(_imbalance(cpu[present, j])
                       for j in range(cpu.shape[1]))

    role_of = dict(roles or {})
    role_imb = {role: 0.0 for role in ATTRIBUTE_ROLES}
    for name, mat in attributes.items():
        role = role_of.get(name) or FALLBACK_ROLES.get(name)
        if role not in role_imb:
            continue
        per_rank = as_matrix(mat)[present].sum(axis=1)
        role_imb[role] = max(role_imb[role], _imbalance(per_rank))

    values = (cpu_imb, cpu_cv, len(gaps) / max(m, 1)) + tuple(
        role_imb[role] for role in ATTRIBUTE_ROLES)
    return WindowFeatures(names=FEATURE_NAMES,
                          values=tuple(float(v) for v in values),
                          region_ids=tuple(int(r) for r in tree.ids()),
                          region_imbalance=region_imb,
                          rank_scores=tuple(float(s) for s in rank_scores))


# ---------------------------------------------------------------------------
# Rough-set strategy (the paper's path — the default)
# ---------------------------------------------------------------------------

def work_imbalance_attrs(entry, which: str = "external",
                         role: str = ROLE_WORK,
                         fallback_attr: str = "instructions"
                         ) -> Tuple[str, ...]:
    """Attributes of ``which`` scope's minimal cores that carry the work
    role.  Any minimal-core *alternative* naming a work attribute counts
    (work imbalance alone then suffices to discern the bottleneck, even when
    a co-varying attribute ties with it); role-less streams fall back to the
    paper's attribute name.  This is the exact test ``ReshardPolicy`` fires
    on — shared here so the rough-set diagnosis and the policy can never
    disagree."""
    named = sorted({a for core in entry.core_alternatives(which)
                    for a in core})
    matched = tuple(a for a in named if entry.role_of(a, which) == role)
    if matched:
        return matched
    if any(entry.role_of(a, which) is not None for a in named):
        return ()          # roles declared; none of them is work
    return tuple(a for a in named if a == fallback_attr)


def _role_pairs(entry, which: str) -> Tuple[Tuple[str, Optional[str]], ...]:
    named = sorted({a for core in entry.core_alternatives(which)
                    for a in core})
    return tuple((a, entry.role_of(a, which) or FALLBACK_ROLES.get(a))
                 for a in named)


class RoughSetStrategy(DiagnosisStrategy):
    """The paper's diagnosis, read through attribute roles.

    External scope (inter-process bottleneck exists): a work-role core names
    ``data_skew`` — exactly when ``ReshardPolicy`` would fire; otherwise the
    first matched role in (network, io, memory) priority order names the
    kind; a core naming nothing interpretable — including the inconsistent
    table an attribute-identical speed difference produces — is ``compute``.
    Internal-only scope: same reading but a work core means compute-heavy.
    Ranks are the gap-aware straggler verdict's; regions the CCCRs."""

    name = "rough"

    def diagnose(self, entry) -> Diagnosis:
        ext = entry.report.external
        if ext.exists:
            verdict = entry.straggler_verdict()
            ranks = tuple(int(r) for r in verdict.stragglers)
            regions = tuple(int(r) for r in ext.cccrs)
            work = work_imbalance_attrs(entry, "external")
            if work:
                ev = tuple((a, entry.role_of(a, "external") or ROLE_WORK)
                           for a in work)
                conf = 1.0 if any(entry.role_of(a, "external") for a in work) \
                    else 0.6
                return Diagnosis(KIND_DATA_SKEW, regions, ranks, conf, ev,
                                 self.name, scope="external")
            pairs = _role_pairs(entry, "external")
            for role in (ROLE_NETWORK, ROLE_IO, ROLE_MEMORY):
                hit = tuple(p for p in pairs if p[1] == role)
                if hit:
                    return Diagnosis(EXTERNAL_ROLE_KIND[role], regions, ranks,
                                     1.0, hit, self.name, scope="external")
            # no attribute discerns the clusters (empty/inconsistent table):
            # the processes differ purely in speed — a slow host
            rc = entry.report.external_root_causes
            conf = 0.75 if rc is not None and rc.core.inconsistent_pairs \
                else 0.5
            return Diagnosis(KIND_COMPUTE, regions, ranks, conf, pairs,
                             self.name, scope="external")
        internal = entry.report.internal
        if internal.cccrs:
            regions = tuple(int(r) for r in internal.cccrs)
            pairs = _role_pairs(entry, "internal")
            for role in (ROLE_MEMORY, ROLE_NETWORK, ROLE_IO, ROLE_WORK):
                hit = tuple(p for p in pairs if p[1] == role)
                if hit:
                    return Diagnosis(INTERNAL_ROLE_KIND[role], regions, (),
                                     1.0, hit, self.name, scope="internal")
            return Diagnosis(KIND_COMPUTE, regions, (), 0.5, pairs,
                             self.name, scope="internal")
        return Diagnosis(KIND_NONE, (), (), 1.0, (), self.name, scope="none")


# ---------------------------------------------------------------------------
# Feature-driven strategies
# ---------------------------------------------------------------------------

#: Kind screened by each role feature, in decision priority order: a case
#: matching an earlier feature never reaches a later check (calibration
#: exploits this — see ``repro.perfdbg.corpus.calibrate_thresholds``).
ROLE_DECISION_ORDER = ((ROLE_WORK, KIND_DATA_SKEW),
                       (ROLE_NETWORK, KIND_NETWORK),
                       (ROLE_IO, KIND_IO),
                       (ROLE_MEMORY, KIND_MEMORY))

#: Uncalibrated defaults: scale-free imbalance cutoffs that separate the
#: injector magnitudes (factor >= 2.5 on >= 1/8 of the pod) from baseline
#: jitter by orders of magnitude.  ``rank_score`` is the straggler cut: a
#: rank 50% over the present-rank mean CPU is singled out.
DEFAULT_CUTOFFS: Dict[str, float] = {
    "cpu_imbalance": 0.1,
    **{f"{role}_imbalance": 0.1 for role in ATTRIBUTE_ROLES},
    "rank_score": 1.5,
}


def _localize(features: Optional[WindowFeatures], kind: str,
              rank_cutoff: float) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shared region/rank targeting for the feature-driven strategies: the
    max-imbalance region, plus every rank whose CPU score clears the cut."""
    if features is None or kind == KIND_NONE:
        return (), ()
    regions: Tuple[int, ...] = ()
    if features.region_imbalance:
        j = int(np.argmax(np.asarray(features.region_imbalance)))
        regions = (features.region_ids[j],)
    ranks = tuple(r for r, s in enumerate(features.rank_scores)
                  if s >= rank_cutoff)
    return regions, ranks


class ThresholdStrategy(DiagnosisStrategy):
    """Calibrated per-role cutoffs over the window feature vector.

    The decision list: below the CPU-imbalance cutoff the window is clean;
    otherwise the first role feature (in :data:`ROLE_DECISION_ORDER`) over
    its cutoff names the kind; a lopsided window with every role feature
    quiet is a pure speed difference (``compute``).  ``cutoffs`` defaults to
    :data:`DEFAULT_CUTOFFS`; calibrate from a labeled corpus split with
    ``repro.perfdbg.corpus.calibrate_thresholds``."""

    name = "threshold"

    def __init__(self, cutoffs: Optional[Mapping[str, float]] = None):
        self.cutoffs = dict(DEFAULT_CUTOFFS)
        if cutoffs:
            self.cutoffs.update({k: float(v) for k, v in cutoffs.items()})

    def diagnose(self, entry) -> Diagnosis:
        f = getattr(entry, "features", None)
        if f is None:
            return Diagnosis(KIND_NONE, (), (), 0.0, (), self.name)
        cpu_imb = f.get("cpu_imbalance")
        cut = self.cutoffs["cpu_imbalance"]
        if cpu_imb < cut:
            conf = min(1.0, (cut - cpu_imb) / max(cut, _TINY))
            return Diagnosis(KIND_NONE, (), (), conf, (), self.name)
        kind, ev, conf = KIND_COMPUTE, (("cpu_imbalance", None),), 0.5
        for role, role_kind in ROLE_DECISION_ORDER:
            name = f"{role}_imbalance"
            val, rcut = f.get(name), self.cutoffs[name]
            if val >= rcut:
                kind, ev = role_kind, ((name, role),)
                conf = min(1.0, val / max(rcut, _TINY) - 1.0)
                break
        regions, ranks = _localize(f, kind, self.cutoffs["rank_score"])
        scope = "external" if ranks else "internal"
        return Diagnosis(kind, regions, ranks, conf, ev, self.name,
                         scope=scope)


class LearnedStrategy(DiagnosisStrategy):
    """Softmax classifier over the standardized feature vector.

    Inference is plain numpy (this module never imports jax); training —
    gradient descent on the multinomial cross-entropy, jax when available —
    lives in ``repro.perfdbg.corpus.fit_learned``.  ``to_state`` /
    ``from_state`` round-trip the model through JSON for checked-in
    artifacts.  Localization reuses the threshold strategy's region/rank
    targeting; confidence is the argmax softmax probability."""

    name = "learned"

    def __init__(self, feature_names: Sequence[str], classes: Sequence[str],
                 mean: np.ndarray, std: np.ndarray,
                 weights: np.ndarray, bias: np.ndarray,
                 rank_cutoff: float = DEFAULT_CUTOFFS["rank_score"]):
        self.feature_names = tuple(feature_names)
        self.classes = tuple(classes)
        self.mean = np.asarray(mean, dtype=np.float64)
        self.std = np.maximum(np.asarray(std, dtype=np.float64), _TINY)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.bias = np.asarray(bias, dtype=np.float64)
        self.rank_cutoff = float(rank_cutoff)
        nf, nc = len(self.feature_names), len(self.classes)
        if self.weights.shape != (nf, nc) or self.bias.shape != (nc,):
            raise ValueError(
                f"model shape mismatch: W {self.weights.shape} b "
                f"{self.bias.shape} for {nf} features x {nc} classes")

    def predict_proba(self, vector: np.ndarray) -> np.ndarray:
        x = (np.asarray(vector, dtype=np.float64) - self.mean) / self.std
        logits = x @ self.weights + self.bias
        logits -= logits.max()
        p = np.exp(logits)
        return p / p.sum()

    def diagnose(self, entry) -> Diagnosis:
        f = getattr(entry, "features", None)
        if f is None:
            return Diagnosis(KIND_NONE, (), (), 0.0, (), self.name)
        p = self.predict_proba(f.vector())
        idx = int(np.argmax(p))
        kind = self.classes[idx]
        regions, ranks = _localize(f, kind, self.rank_cutoff)
        ev = tuple((n, None) for n in self.feature_names
                   if abs(self.weights[self.feature_names.index(n), idx])
                   >= np.abs(self.weights[:, idx]).max() - _TINY)[:1]
        scope = "none" if kind == KIND_NONE else \
            ("external" if ranks else "internal")
        return Diagnosis(kind, regions, ranks, float(p[idx]), ev,
                         self.name, scope=scope)

    # -- persistence ---------------------------------------------------------
    def to_state(self) -> Dict[str, object]:
        return {
            "feature_names": list(self.feature_names),
            "classes": list(self.classes),
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "weights": self.weights.tolist(),
            "bias": self.bias.tolist(),
            "rank_cutoff": self.rank_cutoff,
        }

    @classmethod
    def from_state(cls, state: Mapping[str, object]) -> "LearnedStrategy":
        return cls(state["feature_names"], state["classes"],
                   np.asarray(state["mean"]), np.asarray(state["std"]),
                   np.asarray(state["weights"]), np.asarray(state["bias"]),
                   rank_cutoff=float(state.get(
                       "rank_cutoff", DEFAULT_CUTOFFS["rank_score"])))


#: Strategies constructible with no artifacts (``LearnedStrategy`` needs a
#: trained model — build one via ``repro.perfdbg.corpus.fit_learned`` or
#: ``default_learned_strategy``).
BUILTIN_STRATEGIES = {
    "rough": RoughSetStrategy,
    "threshold": ThresholdStrategy,
}
