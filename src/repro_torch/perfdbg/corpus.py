"""Fault-labeled diagnosis corpus: generation, calibration, training.

The repo's fault injectors can mint an arbitrarily large *labeled* dataset:
we know exactly which bottleneck we injected, where, and how hard.  This
module turns that into a measurement instrument for the
:mod:`repro.core.diagnosis` strategies — a deterministic, seedable generator
that synthesizes per-window rank x region profiles, injects one ground-truth
fault per case (the same fault shapes ``launch/train.py``'s
``--inject-bottleneck-at`` / ``--sim-shard-skew`` / ``--data-skew`` flags
produce), records them through the real :class:`~repro.perfdbg.recorder.
RegionRecorder`, and emits PDWS snapshot blobs paired with JSON labels::

    {"kind": "network", "region": "exchange", "region_id": 3,
     "ranks": [5], "factor": 3.1, "gaps": []}

Fault shapes (``factor`` f, drawn from [2.5, 4.0] — comfortably above the
OPTICS separation scale, matching the injector demos):

* ``compute`` — the region's times scale by f on the faulted ranks, every
  attribute stays put: a slow host, discernible by *no* attribute (the
  rough-set table goes inconsistent).
* ``network`` / ``io`` / ``memory`` — times scale *and* the role's
  attributes scale: the resource that cost the time is visible.
* ``data_skew`` — the faulted ranks' *whole row* scales (times, work and
  I/O counters): they were handed oversized shards.  ``region`` is ``None``
  — the imbalance is not localized to one region.
* ``none`` — baseline jitter only.

Every ``gap_every``-th faulted case is shipped as a *merged* pod view with a
missing host (``merge_snapshots`` gap mask): labels must survive gap-masked
windows, and strategies must never blame a zero-filled rank.

Cases are generated under :data:`repro.perfdbg.straggler.SEVERITY_ALERT`
evaluation semantics: :func:`case_entry` analyzes with
``internal_gate_s=SEVERITY_ALERT``, so a clean window (single cluster, S
below the alert) carries an empty internal report and diagnoses ``none`` —
the production high-rate-session configuration, without which the *relative*
internal severity classes would flag a "most costly region" in every healthy
window.

Calibration / training (the offline half):

* :func:`calibrate_thresholds` — per-feature decision cutoffs from a
  labeled split, exploiting the threshold strategy's screening order.
* :func:`fit_learned` — the softmax classifier (full-batch gradient
  descent, deterministic zero init), trained in numpy: the port has no
  jax, so it runs the reference's numpy update.

``benchmarks/diagnosis_corpus.py`` drives the strategy-vs-strategy accuracy
benchmark over a checked-in mini-corpus (``tests/data/corpus/``,
regenerated by ``tests/data/make_corpus.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.diagnosis import (DEFAULT_CUTOFFS, DIAGNOSIS_KINDS,
                                  KIND_COMPUTE, KIND_DATA_SKEW, KIND_IO,
                                  KIND_MEMORY, KIND_NETWORK, KIND_NONE,
                                  LearnedStrategy, ROLE_DECISION_ORDER,
                                  ThresholdStrategy, WindowFeatures)
from repro_torch.core.regions import RegionTree
from repro_torch.core.roughset import ROLE_IO, ROLE_MEMORY, ROLE_NETWORK, ROLE_WORK
from repro_torch.core.session import AnalysisSession, WindowEntry
from repro_torch.perfdbg.recorder import (RegionRecorder, WindowSnapshot,
                                    merge_snapshots)
from repro_torch.perfdbg.schema import WMEAN, get_schema
from repro_torch.perfdbg.straggler import SEVERITY_ALERT

#: Bumped when the generator's synthesis changes: it feeds the seed
#: sequence, so old and new corpora can never silently mix.
CORPUS_VERSION = 1

#: Flat step phases every case shares (generic SPMD shape: read the shard,
#: compute on it, exchange halos/activations, reduce).
CORPUS_REGIONS = ("load", "compute", "exchange", "reduce")

FAULT_KINDS = tuple(k for k in DIAGNOSIS_KINDS if k != KIND_NONE)

DEFAULT_PER_KIND = 8
DEFAULT_RANKS = 8
#: Every gap_every-th faulted case per kind ships as a merged pod view with
#: a missing host.
DEFAULT_GAP_EVERY = 4

_KIND_ROLE = {KIND_NETWORK: ROLE_NETWORK, KIND_IO: ROLE_IO,
              KIND_MEMORY: ROLE_MEMORY}


def corpus_tree() -> RegionTree:
    tree = RegionTree("step")
    for name in CORPUS_REGIONS:
        tree.add(name)
    return tree


@dataclasses.dataclass(frozen=True)
class CorpusCase:
    """One labeled window: the PDWS snapshot blob + its ground truth."""

    index: int
    blob: bytes
    label: Dict[str, object]

    @property
    def kind(self) -> str:
        return str(self.label["kind"])

    def snapshot(self) -> WindowSnapshot:
        return WindowSnapshot.from_bytes(self.blob)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def _gap_ranks(m: int) -> Tuple[int, ...]:
    """The missing host's rank span for gap cases: a mid-pod hole."""
    lo = m // 2
    return tuple(range(lo, lo + max(1, m // 4)))


def _profile(rng: np.random.Generator, m: int, n: int, schema):
    """Healthy baseline: per-region profiles tiled across ranks with tiny
    relative jitter (1e-4 — orders of magnitude under the clustering eps),
    so an uninjected window is a single cluster."""
    def jitter(shape):
        return 1.0 + 1e-4 * rng.standard_normal(shape)

    cpu = rng.uniform(5.0, 10.0, n) * jitter((m, n))
    wall = cpu * 1.05
    cycles = cpu * 2.2e9
    instr = cycles / rng.uniform(0.8, 1.6, n)
    attrs: Dict[str, np.ndarray] = {}
    for f in schema.fields:
        if f.role == ROLE_WORK or f.source == "instructions":
            continue    # mirrors instructions; materialized after injection
        elif f.reduction == WMEAN:
            attrs[f.name] = rng.uniform(0.05, 0.2, n) * jitter((m, n))
        else:
            attrs[f.name] = rng.uniform(1e6, 5e6, n) * jitter((m, n))
    return {"cpu": cpu, "wall": wall, "cycles": cycles, "instr": instr,
            "attrs": attrs}


def _inject(prof, kind: str, region_col: Optional[int],
            ranks: Sequence[int], factor: float, schema) -> None:
    rr = list(ranks)
    if kind == KIND_DATA_SKEW:
        for key in ("cpu", "wall", "cycles", "instr"):
            prof[key][rr, :] *= factor
        for f in schema.fields:
            if f.role == ROLE_IO:
                prof["attrs"][f.name][rr, :] *= factor
    elif kind != KIND_NONE:
        sel = np.ix_(rr, [region_col])
        for key in ("cpu", "wall", "cycles"):
            prof[key][sel] *= factor
        role = _KIND_ROLE.get(kind)
        if role is not None:
            for f in schema.fields:
                if f.role == role:
                    prof["attrs"][f.name][sel] *= factor
    # work attributes mirror the (possibly skewed) instruction counts
    for f in schema.fields:
        if f.role == ROLE_WORK or f.source == "instructions":
            prof["attrs"][f.name] = prof["instr"].copy()


def _record(tree: RegionTree, schema, prof, ranks: Sequence[int],
            rank_offset: int, label: str) -> WindowSnapshot:
    rec = RegionRecorder(tree, n_ranks=len(ranks), schema=schema,
                         rank_offset=rank_offset)
    ids = tree.ids()
    for i, r in enumerate(ranks):
        for j, rid in enumerate(ids):
            rec.add(i, rid,
                    cpu_time=float(prof["cpu"][r, j]),
                    wall_time=float(prof["wall"][r, j]),
                    cycles=float(prof["cycles"][r, j]),
                    instructions=float(prof["instr"][r, j]),
                    **{f.name: float(prof["attrs"][f.name][r, j])
                       for f in schema.fields})
        rec.add_program_wall(i, float(prof["wall"][r].sum()))
    return rec.snapshot(label)


def generate_case(kind: str, case_num: int, *, index: int, seed: int = 0,
                  n_ranks: int = DEFAULT_RANKS, schema: str = "paper",
                  gap: bool = False) -> CorpusCase:
    """Synthesize one labeled case.  Fully determined by
    ``(CORPUS_VERSION, seed, kind, case_num, n_ranks, schema, gap)`` —
    ``index`` is only the corpus position stamped into the label."""
    if kind not in DIAGNOSIS_KINDS:
        raise ValueError(f"unknown kind {kind!r} (known: {DIAGNOSIS_KINDS})")
    sch = get_schema(schema)
    tree = corpus_tree()
    rng = np.random.default_rng(np.random.SeedSequence(
        [CORPUS_VERSION, seed, DIAGNOSIS_KINDS.index(kind), case_num]))
    prof = _profile(rng, n_ranks, len(tree), sch)
    gaps = _gap_ranks(n_ranks) if gap else ()
    present = [r for r in range(n_ranks) if r not in gaps]

    region_col: Optional[int] = None
    ranks: Tuple[int, ...] = ()
    factor = 1.0
    if kind != KIND_NONE:
        region_col = int(rng.integers(len(tree)))
        k = 2 if (rng.random() < 0.25 and len(present) > 2) else 1
        ranks = tuple(sorted(int(r) for r in
                             rng.choice(present, size=k, replace=False)))
        factor = float(rng.uniform(2.5, 4.0))
    _inject(prof, kind, region_col, ranks, factor, sch)

    text = f"{kind}/{case_num}"
    if gaps:
        head = _record(tree, sch, prof, range(0, gaps[0]), 0, text)
        tail_start = gaps[-1] + 1
        tail = _record(tree, sch, prof, range(tail_start, n_ranks),
                       tail_start, text)
        snap = merge_snapshots([head, None, tail], total_ranks=n_ranks)
    else:
        snap = _record(tree, sch, prof, range(n_ranks), 0, text)

    localized = kind not in (KIND_NONE, KIND_DATA_SKEW)
    rid = tree.ids()[region_col] if localized else None
    label = {
        "case": index,
        "kind": kind,
        "region": tree.name(rid) if rid is not None else None,
        "region_id": rid,
        "ranks": list(ranks),
        "factor": round(factor, 6),
        "gaps": [int(g) for g in gaps],
        "schema": schema,
        "seed": seed,
        "n_ranks": n_ranks,
    }
    return CorpusCase(index=index, blob=snap.to_bytes(), label=label)


def generate_corpus(seed: int = 0, per_kind: int = DEFAULT_PER_KIND,
                    n_ranks: int = DEFAULT_RANKS, schema: str = "paper",
                    kinds: Sequence[str] = DIAGNOSIS_KINDS,
                    gap_every: int = DEFAULT_GAP_EVERY
                    ) -> Tuple[CorpusCase, ...]:
    """The full deterministic corpus, kind-major: ``per_kind`` cases per
    kind.  Same arguments → byte-identical blobs and labels."""
    cases: List[CorpusCase] = []
    for kind in kinds:
        for c in range(per_kind):
            gap = (kind != KIND_NONE and gap_every > 0
                   and c % gap_every == gap_every - 1)
            cases.append(generate_case(
                kind, c, index=len(cases), seed=seed, n_ranks=n_ranks,
                schema=schema, gap=gap))
    return tuple(cases)


# ---------------------------------------------------------------------------
# On-disk format
# ---------------------------------------------------------------------------

def _case_stem(index: int) -> str:
    return f"case_{index:03d}"


def write_corpus(cases: Sequence[CorpusCase], dirpath) -> Dict[str, object]:
    """Write ``case_NNN.pdws`` + ``case_NNN.json`` per case plus a
    ``manifest.json`` carrying per-blob SHA-256 digests (the determinism
    regression anchor).  Returns the manifest."""
    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    entries = []
    for case in cases:
        stem = _case_stem(case.index)
        (d / f"{stem}.pdws").write_bytes(case.blob)
        (d / f"{stem}.json").write_text(
            json.dumps(case.label, indent=2, sort_keys=True) + "\n")
        entries.append({"case": case.index, "kind": case.kind,
                        "sha256": hashlib.sha256(case.blob).hexdigest()})
    manifest = {
        "format": "diagnosis_corpus/v1",
        "corpus_version": CORPUS_VERSION,
        "count": len(cases),
        "cases": entries,
    }
    (d / "manifest.json").write_text(
        json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return manifest


def load_corpus(dirpath) -> Tuple[CorpusCase, ...]:
    """Load a written corpus back (ordered by case index).  Blob digests
    are re-checked against the manifest — a corrupted or hand-edited blob
    fails loudly rather than skewing accuracy numbers."""
    d = pathlib.Path(dirpath)
    manifest = json.loads((d / "manifest.json").read_text())
    cases: List[CorpusCase] = []
    for ent in sorted(manifest["cases"], key=lambda e: e["case"]):
        stem = _case_stem(ent["case"])
        blob = (d / f"{stem}.pdws").read_bytes()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != ent["sha256"]:
            raise ValueError(f"{stem}.pdws digest mismatch: {digest} != "
                             f"manifest {ent['sha256']}")
        label = json.loads((d / f"{stem}.json").read_text())
        cases.append(CorpusCase(index=int(ent["case"]), blob=blob,
                                label=label))
    return tuple(cases)


def split_corpus(cases: Sequence[CorpusCase]
                 ) -> Tuple[Tuple[CorpusCase, ...], Tuple[CorpusCase, ...]]:
    """Deterministic (calibration, evaluation) split: even case indices
    calibrate, odd evaluate.  Kind-major generation makes both halves span
    every kind."""
    calib = tuple(c for c in cases if c.index % 2 == 0)
    evaln = tuple(c for c in cases if c.index % 2 == 1)
    return calib, evaln


# ---------------------------------------------------------------------------
# Analysis plumbing
# ---------------------------------------------------------------------------

def case_entry(case: CorpusCase, strategy=None) -> WindowEntry:
    """Analyze one case through a fresh ``AnalysisSession`` (the corpus
    evaluation context: ``internal_gate_s=SEVERITY_ALERT``, so clean
    windows stay clean — see the module docstring)."""
    snap = case.snapshot()
    session = AnalysisSession(snap.tree, internal_gate_s=SEVERITY_ALERT,
                              strategy=strategy)
    return session.ingest_snapshot(snap)


def labeled_features(cases: Iterable[CorpusCase]
                     ) -> List[Tuple[WindowFeatures, Dict[str, object]]]:
    """(features, label) pairs for calibration/training."""
    out = []
    for case in cases:
        entry = case_entry(case)
        assert entry.features is not None
        out.append((entry.features, case.label))
    return out


# ---------------------------------------------------------------------------
# Threshold calibration
# ---------------------------------------------------------------------------

def _midpoint(neg: Sequence[float], pos: Sequence[float],
              default: float) -> float:
    """Separating cutoff between the negative and positive populations:
    the margin midpoint when they separate cleanly, the mean-of-means
    otherwise; the default when either side is unobserved."""
    if not neg or not pos:
        return default
    lo, hi = max(neg), min(pos)
    if lo < hi:
        return (lo + hi) / 2.0
    return (sum(neg) / len(neg) + sum(pos) / len(pos)) / 2.0


def calibrate_thresholds(
        samples: Sequence[Tuple[WindowFeatures, Mapping[str, object]]]
        ) -> ThresholdStrategy:
    """Fit :class:`~repro.core.diagnosis.ThresholdStrategy` cutoffs from a
    labeled split.

    Each role feature's negatives exclude kinds *screened earlier* in the
    decision order: a ``data_skew`` case never reaches the io check (work
    fires first), so its — genuinely high — io imbalance must not inflate
    the io cutoff.  The rank cutoff separates faulted ranks' CPU scores
    from healthy ranks' across all cases (gap ranks score 0 and are
    excluded)."""
    cutoffs = dict(DEFAULT_CUTOFFS)
    tagged = [(f, str(lab["kind"]), lab) for f, lab in samples]

    neg = [f.get("cpu_imbalance") for f, k, _ in tagged if k == KIND_NONE]
    pos = [f.get("cpu_imbalance") for f, k, _ in tagged if k != KIND_NONE]
    cutoffs["cpu_imbalance"] = _midpoint(neg, pos, cutoffs["cpu_imbalance"])

    for i, (role, kind) in enumerate(ROLE_DECISION_ORDER):
        name = f"{role}_imbalance"
        screened = {k for _, k in ROLE_DECISION_ORDER[:i]}
        pos = [f.get(name) for f, k, _ in tagged if k == kind]
        neg = [f.get(name) for f, k, _ in tagged
               if k != kind and k not in screened]
        cutoffs[name] = _midpoint(neg, pos, cutoffs[name])

    cutoffs["rank_score"] = _rank_cutoff(samples)
    return ThresholdStrategy(cutoffs)


def _rank_cutoff(samples: Sequence[Tuple[WindowFeatures,
                                         Mapping[str, object]]]) -> float:
    """Straggler score cutoff separating faulted ranks from healthy ones
    across all labeled cases (gap ranks score 0 and are excluded)."""
    rank_neg: List[float] = []
    rank_pos: List[float] = []
    for features, lab in samples:
        faulted = {int(r) for r in lab.get("ranks", ())}
        gaps = {int(g) for g in lab.get("gaps", ())}
        for r, score in enumerate(features.rank_scores):
            if r in gaps:
                continue
            (rank_pos if r in faulted else rank_neg).append(score)
    return _midpoint(rank_neg, rank_pos, DEFAULT_CUTOFFS["rank_score"])


# ---------------------------------------------------------------------------
# Learned strategy training
# ---------------------------------------------------------------------------

def fit_learned(samples: Sequence[Tuple[WindowFeatures,
                                        Mapping[str, object]]],
                steps: int = 400, lr: float = 0.5, l2: float = 1e-4,
                use_jax: Optional[bool] = None) -> LearnedStrategy:
    """Train the softmax classifier on a labeled split.

    Full-batch gradient descent on the multinomial cross-entropy from a
    zero init — no randomness, so the fit is deterministic for a fixed
    split.  The update is the reference's numpy one, in float64, equal bit
    for bit to ``repro.perfdbg.corpus.fit_learned(use_jax=False)``.
    ``use_jax`` keeps the reference's signature: ``None`` and ``False``
    both mean numpy, and ``True`` raises, since the port has no jax."""
    if use_jax:
        raise ValueError("fit_learned(use_jax=True): the port has no jax; "
                         "pass use_jax=None or False for the numpy update")
    if not samples:
        raise ValueError("fit_learned needs at least one labeled sample")
    X = np.stack([f.vector() for f, _ in samples])
    names = samples[0][0].names
    y = np.array([DIAGNOSIS_KINDS.index(str(lab["kind"]))
                  for _, lab in samples])
    mean = X.mean(axis=0)
    std = np.maximum(X.std(axis=0), 1e-12)
    Xs = (X - mean) / std
    Y = np.eye(len(DIAGNOSIS_KINDS))[y]

    W_np = np.zeros((Xs.shape[1], Y.shape[1]))
    b_np = np.zeros(Y.shape[1])
    for _ in range(steps):
        logits = Xs @ W_np + b_np
        logits -= logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        p = e / e.sum(axis=1, keepdims=True)
        g = (p - Y) / Xs.shape[0]
        W_np -= lr * (Xs.T @ g + l2 * W_np)
        b_np -= lr * g.sum(axis=0)

    return LearnedStrategy(feature_names=names, classes=DIAGNOSIS_KINDS,
                           mean=mean, std=std, weights=W_np, bias=b_np,
                           rank_cutoff=_rank_cutoff(samples))


def default_learned_strategy(seed: int = 0,
                             per_kind: int = 4) -> LearnedStrategy:
    """A ready-to-attach :class:`~repro.core.diagnosis.LearnedStrategy`
    fit on a freshly generated in-memory mini corpus — what
    ``launch/train.py --diagnosis learned`` constructs at startup."""
    cases = generate_corpus(seed=seed, per_kind=per_kind)
    return fit_learned(labeled_features(cases))
