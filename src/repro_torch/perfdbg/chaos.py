"""Seeded chaos harness: prove the measurement→transport→analysis path
survives faults, with exact accounting (perfdbg layer: blob mangling and
synthetic streams; the transport merge is reached lazily, same pattern as
``core.session`` → ``perfdbg.straggler``).

Every fault decision is a pure function of ``(seed, kind, window, host)``
via ``np.random.SeedSequence`` — two runs with the same seed inject the
identical schedule, so property tests and the CI chaos-soak can assert
exact outcomes, not distributions.  ``force`` pins specific faults on top
of the seeded rates (the soak greps for *those* audit lines).

Fault kinds (:data:`FAULT_KINDS`):

==========  ============================================================
truncate    host's blob cut short → parse fails → quarantined as corrupt
bitflip     one bit flipped past the wire prefix → checksum/parse fails →
            corrupt
drop        host contributes nothing this window (process died)
delay       host's blob misses the collection deadline (late producer);
            same containment as drop, counted separately
skew        wire version patched to an unknown value → quarantined as
            version skew (an incompatible peer, not bit damage)
analyzer    ``ChaosSession`` raises :class:`ChaosError` inside the
            analysis stage → supervised tombstone
journal     ``ChaosJournal`` fails the append → counted, never raised
==========  ============================================================

:func:`run_chaos` wires the full loop — synthetic stream → per-host shard
blobs → injector → lenient merge (``TransportHealth``) → supervised
``AsyncAnalysisSession`` (+ optional journal + policy engine) — and
returns a :class:`ChaosResult` whose :meth:`~ChaosResult.check` asserts
the accounting invariant::

    analyzed + failed + dropped == submitted
    submitted + no_contributors == windows

``python -m repro.perfdbg.chaos`` runs it from the command line (the CI
``chaos-soak`` job's entry point) and exits nonzero on any violation.
"""
from __future__ import annotations

import argparse
import dataclasses
import struct
import sys
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import RegionTree
from repro_torch.core.journal import JournalError, WindowJournal
from repro_torch.core.pipeline import AsyncAnalysisSession
from repro_torch.core.session import AnalysisSession, SessionReport

from .recorder import RegionRecorder, WindowSnapshot

FAULT_KINDS = ("truncate", "bitflip", "drop", "delay", "skew", "analyzer",
               "journal")

#: default per-(window, host) injection probabilities for :func:`run_chaos`
DEFAULT_RATES: Dict[str, float] = {
    "truncate": 0.08, "bitflip": 0.08, "drop": 0.08, "delay": 0.04,
    "skew": 0.04, "analyzer": 0.08, "journal": 0.10,
}

_PREFIX_SIZE = struct.calcsize("<4sHI")   # the PDWS wire prefix


class ChaosError(RuntimeError):
    """An injected analyzer failure (never raised by real analysis)."""


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """One fault the injector actually fired."""
    kind: str
    window: int
    host: int


class ChaosInjector:
    """Deterministic seeded fault source.

    ``rates`` maps fault kind → probability per (window, host) site;
    ``force`` maps kind → explicit ``(window, host)`` sites that fire
    regardless of the roll (for reproducible CI greps).  Decisions are
    memoized per site, so asking twice neither re-rolls nor double-counts
    — :attr:`faults` is the exact schedule that fired, in first-asked
    order."""

    def __init__(self, seed: int, rates: Optional[Mapping[str, float]] = None,
                 force: Optional[Mapping[str, Sequence[Tuple[int, int]]]] = None):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        unknown = set(self.rates) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kind(s) {sorted(unknown)} "
                             f"(known: {FAULT_KINDS})")
        self.force = {k: {tuple(site) for site in v}
                      for k, v in (force or {}).items()}
        unknown = set(self.force) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown forced fault kind(s) {sorted(unknown)}")
        self.faults: List[InjectedFault] = []
        self._decisions: Dict[Tuple[str, int, int], bool] = {}

    def _rng(self, kind: str, window: int, host: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, FAULT_KINDS.index(kind), int(window), int(host)]))

    def decide(self, kind: str, window: int, host: int = 0) -> bool:
        """Does ``kind`` fire at this (window, host) site?  Pure in
        (seed, kind, window, host); memoized."""
        key = (kind, int(window), int(host))
        hit = self._decisions.get(key)
        if hit is None:
            hit = key[1:] in self.force.get(kind, ())
            rate = self.rates.get(kind, 0.0)
            if not hit and rate > 0.0:
                hit = float(self._rng(kind, window, host).random()) < rate
            self._decisions[key] = hit
            if hit:
                self.faults.append(InjectedFault(kind, int(window), int(host)))
        return hit

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    # -- transport faults ----------------------------------------------------
    def mangle_blob(self, blob: bytes, window: int, host: int
                    ) -> Optional[bytes]:
        """Apply at most one transport fault to a host's serialized shard;
        ``None`` means the host shipped nothing (drop/delay)."""
        if self.decide("drop", window, host) or \
                self.decide("delay", window, host):
            return None
        if self.decide("truncate", window, host):
            rng = self._rng("truncate", window, host)
            cut = int(rng.integers(1, max(2, len(blob) - 8)))
            return blob[:cut]
        if self.decide("bitflip", window, host):
            rng = self._rng("bitflip", window, host)
            # stay past the wire prefix so a flip is always bit damage
            # (corrupt), never an accidental version change (skew)
            pos = int(rng.integers(_PREFIX_SIZE, len(blob)))
            bit = int(rng.integers(0, 8))
            out = bytearray(blob)
            out[pos] ^= 1 << bit
            return bytes(out)
        if self.decide("skew", window, host):
            out = bytearray(blob)
            struct.pack_into("<H", out, 4, 9999)   # unknown wire version
            return bytes(out)
        return blob


def shard_blobs(snap: WindowSnapshot, hosts: int, *,
                checksum: bool = True) -> List[bytes]:
    """Slice a pod-wide snapshot into ``hosts`` contiguous per-host shard
    blobs (rank offsets stamped), as if each host had serialized its own
    recorder — the injector's input, and exactly what a real
    ``SnapshotCollector.gather`` would transport."""
    m = snap.n_ranks
    if not 1 <= hosts <= m:
        raise ValueError(f"hosts must be in [1, {m}], got {hosts}")
    bounds = np.linspace(0, m, hosts + 1).astype(int)
    out = []
    for h in range(hosts):
        lo, hi = int(bounds[h]), int(bounds[h + 1])
        shard = WindowSnapshot(
            snap.index, snap.schema, snap.tree,
            snap.data[lo:hi].copy(), snap.program_wall[lo:hi].copy(),
            snap.label, rank_offset=lo)
        out.append(shard.to_bytes(checksum=checksum))
    return out


class ChaosSession(AnalysisSession):
    """An :class:`AnalysisSession` whose analysis stage raises
    :class:`ChaosError` at injector-chosen windows — the supervised
    pipeline's poison pill, on both the single-worker path
    (``ingest_snapshot``) and the pooled path (``prepare_snapshot``)."""

    def __init__(self, tree: RegionTree, injector: ChaosInjector, **kw):
        super().__init__(tree, **kw)
        self.injector = injector

    def check_analyzer_fault(self, snap) -> None:
        """Raise :class:`ChaosError` iff the injector schedules an analyzer
        fault at this window.  Public because the pipeline's process
        executor calls it in the *parent* before shipping the blob — the
        fault decision is pure in the window index, so tombstones land in
        identical timeline slots for every executor kind."""
        if self.injector.decide("analyzer", int(snap.index)):
            raise ChaosError(
                f"injected analyzer fault at window {snap.index}")

    def ingest_snapshot(self, snap, label=None):
        self.check_analyzer_fault(snap)
        return super().ingest_snapshot(snap, label=label)

    def prepare_snapshot(self, snap, label=None, memo=None):
        self.check_analyzer_fault(snap)
        return super().prepare_snapshot(snap, label=label, memo=memo)


class ChaosJournal:
    """Wraps a :class:`~repro.core.journal.WindowJournal`; injector-chosen
    appends raise :class:`~repro.core.journal.JournalError` *after* the
    record is withheld (a failed write must not half-commit).  The
    supervised pipeline counts these on ``journal_errors``."""

    def __init__(self, journal: WindowJournal, injector: ChaosInjector):
        self.journal = journal
        self.injector = injector

    def append(self, seq: int, blob: bytes, label=None) -> None:
        if self.injector.decide("journal", int(seq)):
            raise JournalError(f"injected journal write failure at seq {seq}")
        self.journal.append(seq, blob, label=label)

    def close(self) -> None:
        self.journal.close()


def synthetic_tree() -> RegionTree:
    tree = RegionTree()
    for i, name in enumerate(("load", "compute", "allreduce"), start=1):
        tree.add(name, rid=i)
    return tree


def synthetic_stream(tree: RegionTree, windows: int, ranks: int,
                     hot_every: int = 4) -> List[WindowSnapshot]:
    """Deterministic pod-wide window stream: every ``hot_every``-th window
    the ``compute`` region runs 8x hot on one rotating rank (a migrating
    bottleneck the analyzer must keep flagging between faults)."""
    rec = RegionRecorder(tree, n_ranks=ranks)
    out = []
    for w in range(windows):
        hot_rank = w % ranks
        for r in range(ranks):
            for rid in tree.ids():
                hot = 8.0 if (w % hot_every == hot_every - 1
                              and rid == 2 and r == hot_rank) else 1.0
                rec.add(r, rid, cpu_time=hot, wall_time=hot,
                        cycles=hot * 2e9, instructions=1e9)
            rec.add_program_wall(r, 3.0 + (w % 3) * 0.25)
        out.append(rec.reset_window(f"w{w}"))
    return out


@dataclasses.dataclass
class ChaosResult:
    """Everything a soak needs to assert: exact accounting, the fault
    schedule that fired, transport health, and the rendered report."""

    windows: int
    submitted: int
    analyzed: int
    failed: int
    dropped: int
    no_contributors: int
    journal_errors: int
    worker_restarts: int
    faults: Tuple[InjectedFault, ...]
    fault_counts: Dict[str, int]
    health: object                      # launch.collect.TransportHealth
    report: SessionReport
    report_text: str
    policy_entries: int

    def check(self) -> "ChaosResult":
        """Assert the survival invariant; returns self for chaining."""
        if self.analyzed + self.failed + self.dropped != self.submitted:
            raise AssertionError(
                f"accounting violated: analyzed={self.analyzed} + "
                f"failed={self.failed} + dropped={self.dropped} != "
                f"submitted={self.submitted}")
        if self.submitted + self.no_contributors != self.windows:
            raise AssertionError(
                f"accounting violated: submitted={self.submitted} + "
                f"no_contributors={self.no_contributors} != "
                f"windows={self.windows}")
        if len(self.report.windows) != self.analyzed + self.failed:
            raise AssertionError(
                f"timeline holds {len(self.report.windows)} entries, "
                f"expected {self.analyzed + self.failed}")
        return self


def run_chaos(seed: int = 0, windows: int = 12, hosts: int = 2,
              ranks_per_host: int = 2, *,
              rates: Optional[Mapping[str, float]] = None,
              force: Optional[Mapping[str, Sequence[Tuple[int, int]]]] = None,
              workers: int = 1, executor: str = "thread",
              escalate_after: int = 10**9,
              journal_path: Optional[str] = None,
              policies: Optional[str] = None,
              verbose: bool = False) -> ChaosResult:
    """One full chaos run over a synthetic pod (see the module docstring).
    ``rates=None`` uses :data:`DEFAULT_RATES`; pass ``{}`` (and no
    ``force``) for a fault-free run — whose report is byte-identical to an
    unsupervised, un-instrumented session over the same stream.
    ``escalate_after`` defaults to effectively-never: a soak measures
    containment, not escalation."""
    from repro_torch.launch.collect import TransportHealth, merge_blobs  # lazy:
    # perfdbg never imports launch at module level (layering invariant)
    from repro_torch.core.policy import (CollectorQuarantinePolicy, PolicyEngine,
                                   make_policies)

    tree = synthetic_tree()
    total = hosts * ranks_per_host
    stream = synthetic_stream(tree, windows, total)
    injector = ChaosInjector(
        seed, rates=DEFAULT_RATES if rates is None else rates, force=force)
    health = TransportHealth()
    engine = None
    if policies:
        built = make_policies(policies)
        for p in built:
            if isinstance(p, CollectorQuarantinePolicy):
                p.health = health
        engine = PolicyEngine(built)
    journal = None
    if journal_path is not None:
        journal = ChaosJournal(WindowJournal(journal_path), injector)
    session = ChaosSession(tree, injector)
    pipe = AsyncAnalysisSession(
        tree, session=session, supervised=True,
        escalate_after=escalate_after, journal=journal,
        policy_engine=engine, workers=workers, executor=executor)
    no_contributors = 0
    for w, snap in enumerate(stream):
        blobs = shard_blobs(snap, hosts)
        mangled = [injector.mangle_blob(b, w, h)
                   for h, b in enumerate(blobs)]
        try:
            merged = merge_blobs(mangled, tree=tree, total_ranks=total,
                                 strict=False, health=health)
        except ValueError:
            no_contributors += 1
            if verbose:
                print(f"[chaos] window w{w} dropped: no contributors")
            continue
        pipe.submit(merged, label=f"w{w}")
    report = pipe.close()
    return ChaosResult(
        windows=windows, submitted=pipe.submitted, analyzed=pipe.analyzed,
        failed=pipe.failed, dropped=pipe.dropped,
        no_contributors=no_contributors,
        journal_errors=pipe.journal_errors,
        worker_restarts=pipe.worker_restarts,
        faults=tuple(injector.faults), fault_counts=injector.counts(),
        health=health, report=report, report_text=report.render(tree),
        policy_entries=len(engine.log) if engine is not None else 0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos soak over the supervised analysis pipeline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", type=int, default=24)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--ranks-per-host", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--executor", default="thread",
                    choices=("thread", "process"),
                    help="analysis executor kind (tombstones land in the "
                         "same windows either way)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="multiply every DEFAULT_RATES entry")
    ap.add_argument("--journal", default=None, metavar="FILE")
    ap.add_argument("--policies", default=None,
                    help='policy spec, e.g. "quarantine" or "all"')
    args = ap.parse_args(argv)

    rates = {k: min(1.0, v * args.rate_scale)
             for k, v in DEFAULT_RATES.items()}
    res = run_chaos(args.seed, args.windows, args.hosts, args.ranks_per_host,
                    rates=rates, workers=args.workers,
                    executor=args.executor,
                    journal_path=args.journal, policies=args.policies,
                    verbose=True)
    for f in res.faults:
        print(f"[chaos] injected {f.kind} at window w{f.window} "
              f"host {f.host}")
    print(res.health.render())
    print(res.report_text)
    print(f"[chaos] windows={res.windows} submitted={res.submitted} "
          f"analyzed={res.analyzed} failed={res.failed} "
          f"dropped={res.dropped} no_contributors={res.no_contributors} "
          f"journal_errors={res.journal_errors} "
          f"restarts={res.worker_restarts} "
          f"faults={len(res.faults)} policy_entries={res.policy_entries}")
    try:
        res.check()
    except AssertionError as e:
        print(f"[chaos] ACCOUNTING FAILED: {e}", file=sys.stderr)
        return 1
    print("[chaos] accounting exact: analyzed + failed + dropped == submitted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
