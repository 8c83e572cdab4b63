"""Off-critical-path analysis: AnalysisSession behind a worker pool
(core layer: threading only — no jax, no transport; the drivers own both).

The paper's pipeline is cheap (clustering over an m x n matrix), but "cheap"
is still synchronous work on the training step loop.  ``AsyncAnalysisSession``
moves ingestion onto ``workers`` threads behind a bounded snapshot queue, so
a windowed run pays only the ``snapshot()`` copy per window — the paper's
125*n*m-byte contract is exactly what makes that copy affordable.

Contract:

* ``submit`` / ``submit_recorder`` enqueue a frozen window.  Queue full?
  ``backpressure`` decides: ``"block"`` waits for a worker (analysis never
  loses a window; the step loop may stall), ``"drop_oldest"`` evicts the
  oldest *pending* window (the step loop never stalls; ``dropped`` counts
  the losses).  Windows are *assembled* strictly in submission order
  regardless of worker count, so the resulting ``SessionReport`` is
  byte-identical to the synchronous session's.
* ``drain()`` blocks until everything submitted so far is analyzed and
  returns the current ``SessionReport``.
* ``close()`` drains, stops the workers, and returns the final report; the
  session is also a context manager (``with AsyncAnalysisSession(t) as s:``).
* A crash in a worker (analysis, the policy engine, or the ``on_window``
  callback) is captured and re-raised — with the original exception as the
  cause — from the next ``submit``/``drain``/``close``.
* ``supervised=True`` *contains* analysis failures instead: the window is
  tombstoned into the timeline as a ``failed`` entry (exception text as
  evidence, see ``AnalysisSession.ingest_failure``), the worker is
  restarted, and the run continues.  Only ``escalate_after`` *consecutive*
  failures escalate to the re-raise path above — a systematically broken
  analyzer still crashes, a window-local poison pill does not.  On clean
  input a supervised session's report is byte-identical to an
  unsupervised one's.  Callback (policy/``on_window``) crashes still
  escalate immediately: those are driver bugs, not data faults.
* ``journal`` (a ``core.journal.WindowJournal``) records every submitted
  window's blob before it enters the queue; after a process crash,
  ``core.journal.replay`` rebuilds the byte-identical timeline.  Journal
  write failures never stall submission — they are counted on
  ``journal_errors`` and the run continues (the journal is a durability
  aid, not a dependency).
* A ``policy_engine`` (``core.policy.PolicyEngine``) attached at
  construction runs during in-order assembly after each window is analyzed
  — *before* ``on_window``, so the callback can print this window's
  decisions.  Fired actions accumulate and are collected with
  ``take_actions()``; after ``drain()`` returns, every action from every
  window submitted before the drain has been collected or is collectable.
  Because assembly is strictly in submission order, the engine sees the
  identical entry stream the synchronous driver would feed it — policy
  decisions are deterministic across the two paths *and across worker
  counts*.

Worker pool (``workers > 1``): each worker claims the next queued window
and runs the thread-safe analysis stage
(:meth:`~repro.core.session.AnalysisSession.prepare_snapshot`) concurrently
with the others; a single in-order assembler then applies
:meth:`~repro.core.session.AnalysisSession.ingest_prepared`, the policy
engine, and ``on_window`` strictly by submission sequence (whichever worker
completes the next-due window drives assembly until it runs dry).
Incremental reuse stays on: concurrent preparers fingerprint against the
latest *assembled* window's memo — possibly stale, never wrong, since reuse
only substitutes results for fingerprint-equal inputs.  With ``workers == 1``
(thread executor) the worker ingests directly via ``ingest_snapshot`` (the
pre-pool path, same hooks, same cache-hit pattern).

``executor="process"`` shards the prepare stage across *worker processes*
instead of threads — past the GIL, for analysis-bound timelines where the
numpy stages leave too little released-GIL time to overlap.  Each claimed
window is serialized to its PDWS wire blob and shipped to a spawn-pool
replica of the analysis session (see ``_process_worker_init``); the prepared
result pickles back and flows through the *same* single in-order assembler,
so ``SessionReport.render()`` stays byte-identical and the ``PolicyLog``
identical across executor kinds and worker counts.  Supervision semantics
are intact: analysis faults (including chaos-injected ones, which fire in
the parent via the session's ``check_analyzer_fault`` hook) tombstone the
same windows they would under threads.
"""
from __future__ import annotations

import collections
import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional

from .regions import RegionTree
from .session import AnalysisSession, SessionReport, WindowEntry

BLOCK = "block"
DROP_OLDEST = "drop_oldest"
BACKPRESSURE_POLICIES = (BLOCK, DROP_OLDEST)

THREAD = "thread"
PROCESS = "process"
EXECUTOR_KINDS = (THREAD, PROCESS)

#: assembler sentinel for a submission sequence evicted by ``drop_oldest``
_DROPPED = object()


# -- process-pool prepare stage ----------------------------------------------
# The child side of ``executor="process"``: each worker process holds a
# *replica* AnalysisSession built from the parent session's configuration
# (tree spec + scalar knobs) and runs the thread-safe analysis stage on
# windows shipped as PDWS wire blobs — the format is fully self-describing
# (schema + tree specs ride in the header), so the replica needs no shared
# state with the parent.  Each replica keeps its own memo chain for
# incremental reuse: child-locally "latest prepared", possibly stale
# relative to the pod timeline, never wrong (reuse only substitutes results
# for fingerprint-equal inputs).  The prepared result (frozen report +
# memo + features, plain dataclasses over numpy) pickles back to the
# parent's in-order assembler.

_CHILD_SESSION: Optional[AnalysisSession] = None
_CHILD_MEMO = None


class _SaltStrategy:
    """Carries only the parent strategy's reuse-fingerprint salt into the
    child replicas; diagnosis itself runs in the parent's assembler
    (``ingest_prepared``), never in a child."""

    def __init__(self, name: str):
        self.name = name

    def diagnose(self, entry):   # pragma: no cover - never called in a child
        return None


def _process_worker_init(tree_spec, cfg: dict) -> None:
    global _CHILD_SESSION, _CHILD_MEMO
    tree = RegionTree.from_spec(tree_spec)
    _CHILD_SESSION = AnalysisSession(
        tree, reuse=cfg["reuse"], internal_gate_s=cfg["internal_gate_s"],
        collapse=cfg["collapse"], column_workers=cfg["column_workers"],
        strategy=_SaltStrategy(cfg["strategy_salt"]))
    _CHILD_MEMO = None


def _process_prepare(blob: bytes, label):
    global _CHILD_MEMO
    from repro_torch.perfdbg.recorder import WindowSnapshot   # lazy: core never
    # imports perfdbg at module level (layering invariant)
    snap = WindowSnapshot.from_bytes(blob)
    prepared = _CHILD_SESSION.prepare_snapshot(snap, label=label,
                                               memo=_CHILD_MEMO)
    if _CHILD_SESSION.reuse:
        _CHILD_MEMO = prepared.memo
    return prepared


class PipelineClosed(RuntimeError):
    """submit() after close()."""


class _PrepareFailure:
    """A worker's analysis stage raised; assembled in order as a failure
    (supervised sessions tombstone it under the window's label)."""

    __slots__ = ("error", "label")

    def __init__(self, error: BaseException, label=None):
        self.error = error
        self.label = label


class AsyncAnalysisSession:
    """Bounded-queue worker pool around :class:`AnalysisSession`.

    ``on_window`` (optional) runs on a worker thread after each window is
    assembled — the place for progress lines or window-adaptive policies.
    Access the wrapped session's state only via ``drain()``/``close()``
    results (or inside ``on_window``); anything else races the workers.

    ``workers`` sizes the pool sharding *independent windows*; submission
    order is preserved end to end (see the module docstring).  With a
    custom ``session`` subclass note the hook difference: the pool drives
    ``prepare_snapshot``/``ingest_prepared``, while ``workers == 1`` under
    the thread executor drives ``ingest_snapshot``.

    ``executor`` picks where the prepare stage runs: ``"thread"`` (default)
    shares the parent session across pool threads; ``"process"`` ships each
    window's wire blob to a spawn-pool session replica (configuration read
    off the wrapped session — works with a custom ``session=`` too) and is
    pooled even at ``workers == 1``.  Reports and policy decisions are
    identical either way.
    """

    def __init__(self, tree: RegionTree, *, keep_windows: Optional[int] = None,
                 max_queue: int = 8, backpressure: str = BLOCK,
                 on_window: Optional[Callable[[WindowEntry], None]] = None,
                 session: Optional[AnalysisSession] = None,
                 policy_engine=None, reuse: bool = True,
                 internal_gate_s: Optional[float] = None,
                 workers: int = 1, executor: str = THREAD,
                 collapse: Optional[str] = None,
                 column_workers: Optional[int] = None, strategy=None,
                 supervised: bool = False, escalate_after: int = 3,
                 journal=None,
                 on_failure: Optional[Callable[[WindowEntry], None]] = None):
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(f"backpressure must be one of "
                             f"{BACKPRESSURE_POLICIES}, got {backpressure!r}")
        if executor not in EXECUTOR_KINDS:
            raise ValueError(f"executor must be one of {EXECUTOR_KINDS}, "
                             f"got {executor!r}")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if escalate_after < 1:
            raise ValueError("escalate_after must be >= 1")
        if session is not None and (keep_windows is not None
                                    or not reuse
                                    or internal_gate_s is not None
                                    or collapse is not None
                                    or column_workers is not None
                                    or strategy is not None):
            raise ValueError(
                "session= conflicts with keep_windows/reuse/internal_gate_s/"
                "collapse/column_workers/strategy — configure the "
                "AnalysisSession you pass in instead")
        self.tree = tree
        if session is not None:
            self._session = session
        else:
            kw = {}
            if collapse is not None:
                kw["collapse"] = collapse
            if column_workers is not None:
                kw["column_workers"] = column_workers
            if strategy is not None:
                kw["strategy"] = strategy
            self._session = AnalysisSession(tree, keep_windows, reuse=reuse,
                                            internal_gate_s=internal_gate_s,
                                            **kw)
        self._max_queue = max_queue
        self._policy = backpressure
        self._on_window = on_window
        self._engine = policy_engine
        self._workers_n = workers
        self._executor = executor
        # the pooled (prepare/assemble) path runs whenever preparation is
        # sharded — across threads (workers > 1) or across processes (any
        # worker count: even one process worker needs the blob round-trip)
        self._pooled = workers > 1 or executor == PROCESS
        self._proc_pool: Optional[ProcessPoolExecutor] = None
        if executor == PROCESS:
            s = self._session
            cfg = {"reuse": s.reuse, "internal_gate_s": s.internal_gate_s,
                   "collapse": s.collapse,
                   "column_workers": s.column_workers,
                   "strategy_salt": getattr(s.strategy, "name", "")}
            # spawn, not fork: worker replicas must not inherit the parent's
            # thread/lock state, and the core layer stays jax-free either way
            self._proc_pool = ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(s.tree.to_spec(), cfg))
        self._supervised = supervised
        self._escalate_after = escalate_after
        self._on_failure = on_failure
        self._journal = journal
        self._journal_errors = 0
        self._streak = 0          # consecutive contained failures (by _cv)
        self._restarts = 0        # supervised single-worker replacements
        self._actions: List = []   # fired, not yet taken (guarded by _cv)
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._submitted = 0      # windows accepted into the queue
        self._done = 0           # windows assembled, dropped, or failed
        self._dropped = 0
        self._failed = 0         # analysis (or ingest) raised
        self._closed = False
        self._error: Optional[BaseException] = None
        # pool state (guarded by _cv)
        self._results: Dict[int, object] = {}  # seq -> PreparedWindow/_PrepareFailure/_DROPPED
        self._next_assemble = 0   # next submission sequence due for assembly
        self._assembling = False  # one assembler at a time
        self._inflight = 0        # claimed but result not yet posted
        self._latest_memo = None  # memo of the last assembled window
        run = self._run_single if not self._pooled else self._run_pooled
        self._threads = [
            threading.Thread(target=run, name=f"perfdbg-analysis-{i}",
                             daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    # -- single-worker path (the pre-pool loop, plus supervision) ------------
    def _run_single(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:          # closed and fully drained
                    return
                _, snap, label = self._q.popleft()
                self._cv.notify_all()    # a blocked producer may proceed
            err = None
            ingested = False
            fired = []
            try:
                entry = self._session.ingest_snapshot(snap, label=label)
                ingested = True
                if self._engine is not None:
                    fired = self._engine.observe(entry, self._session)
                if self._on_window is not None:
                    self._on_window(entry)
            except BaseException as e:   # propagate to the producer side
                err = e
            contained = (err is not None and not ingested and self._supervised)
            if contained:
                self._tombstone(label or getattr(snap, "label", None), err)
            restart = False
            with self._cv:
                if fired:
                    self._actions.extend(fired)
                if err is not None:
                    if not ingested:   # a callback crash still ingested
                        self._failed += 1
                    if contained:
                        self._streak += 1
                        if self._streak >= self._escalate_after:
                            if self._error is None:
                                self._error = err
                        else:
                            restart = True
                    elif self._error is None:
                        self._error = err
                elif ingested:
                    self._streak = 0
                self._done += 1
                self._cv.notify_all()
            if restart:
                # the contained exception may have left thread-local state
                # (profilers, numpy errstate) dirty: hand the loop to a
                # fresh worker thread and retire this one
                with self._cv:
                    self._restarts += 1
                    t = threading.Thread(
                        target=self._run_single,
                        name=f"perfdbg-analysis-r{self._restarts}",
                        daemon=True)
                    self._threads.append(t)
                t.start()
                return

    def _tombstone(self, label, err: BaseException) -> None:
        """Record one contained failure in the timeline (supervised mode).
        Runs on the thread that owns the session at that moment (the
        single worker, or the in-order assembler)."""
        entry = None
        try:
            entry = self._session.ingest_failure(
                label=label, error=f"{type(err).__name__}: {err}")
        except BaseException:
            pass                        # containment must not cascade
        if entry is not None and self._on_failure is not None:
            try:
                self._on_failure(entry)
            except BaseException:
                pass

    # -- pooled path ---------------------------------------------------------
    def _run_pooled(self) -> None:
        while True:
            self._assemble_ready()
            with self._cv:
                claimed = None
                while True:
                    if self._q:
                        claimed = self._q.popleft()
                        self._inflight += 1
                        memo = self._latest_memo
                        self._cv.notify_all()   # a blocked producer may proceed
                        break
                    if self._can_assemble():
                        break                    # go run the assembler
                    if (self._closed and not self._inflight
                            and not self._results):
                        return
                    self._cv.wait()
            if claimed is None:
                continue
            seq, snap, label = claimed
            try:
                if self._proc_pool is not None:
                    # fault-injection hooks (chaos sessions) must fire in the
                    # parent, deterministically per window, so tombstones land
                    # in the same timeline slots for every executor kind
                    check = getattr(self._session, "check_analyzer_fault",
                                    None)
                    if check is not None:
                        check(snap)
                    outcome: object = self._proc_pool.submit(
                        _process_prepare, snap.to_bytes(),
                        label or getattr(snap, "label", None)).result()
                else:
                    outcome = self._session.prepare_snapshot(
                        snap, label=label, memo=memo)
            except BaseException as e:
                outcome = _PrepareFailure(
                    e, label=label or getattr(snap, "label", None))
            with self._cv:
                self._results[seq] = outcome
                self._inflight -= 1
                self._cv.notify_all()

    def _can_assemble(self) -> bool:
        return not self._assembling and self._next_assemble in self._results

    def _assemble_ready(self) -> None:
        """Assemble every consecutive completed window starting at the next
        due sequence.  One assembler at a time; re-checks after releasing
        the flag so a result posted during the hand-off is never stranded."""
        while True:
            with self._cv:
                if not self._can_assemble():
                    return
                self._assembling = True
            try:
                while True:
                    with self._cv:
                        item = self._results.pop(self._next_assemble, None)
                        if item is None:
                            break
                        self._next_assemble += 1
                    if item is not _DROPPED:   # drops were counted at eviction
                        self._assemble_one(item)
            finally:
                with self._cv:
                    self._assembling = False
                    self._cv.notify_all()

    def _assemble_one(self, outcome) -> None:
        err: Optional[BaseException] = None
        failed = False
        fired = []
        entry = None
        if isinstance(outcome, _PrepareFailure):
            err, failed = outcome.error, True
            label = outcome.label
        else:
            label = outcome.label
            try:
                entry = self._session.ingest_prepared(outcome)
            except BaseException as e:
                err, failed = e, True
            else:
                try:
                    if self._engine is not None:
                        fired = self._engine.observe(entry, self._session)
                    if self._on_window is not None:
                        self._on_window(entry)
                except BaseException as e:   # ingested: analyzed, but surface
                    err = e
        contained = failed and self._supervised
        if contained:
            self._tombstone(label, err)
        with self._cv:
            if fired:
                self._actions.extend(fired)
            if err is not None:
                if failed:
                    self._failed += 1
                if contained:
                    self._streak += 1
                    if (self._streak >= self._escalate_after
                            and self._error is None):
                        self._error = err
                elif self._error is None:
                    self._error = err
            if entry is not None:
                self._streak = 0
                self._latest_memo = self._session.latest_memo
            self._done += 1
            self._cv.notify_all()

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise RuntimeError("analysis worker failed") from self._error

    # -- producer side -------------------------------------------------------
    def submit(self, snap, label: Optional[str] = None) -> None:
        """Enqueue one frozen window (a ``WindowSnapshot``); the only cost
        on the caller is the queue append (or a wait under ``block``) —
        plus, with a ``journal`` attached, one local append of the
        serialized blob (write failures counted, never raised)."""
        with self._cv:
            self._raise_pending()
            if self._closed:
                raise PipelineClosed("submit() on a closed pipeline")
            if self._journal is not None:
                try:
                    self._journal.append(self._submitted, snap.to_bytes(),
                                         label=label or snap.label)
                except Exception:
                    self._journal_errors += 1
            if self._policy == BLOCK:
                while len(self._q) >= self._max_queue and not self._closed:
                    self._cv.wait()
                self._raise_pending()
                if self._closed:
                    raise PipelineClosed("pipeline closed while blocked")
            else:
                while len(self._q) >= self._max_queue:
                    seq, _, _ = self._q.popleft()
                    self._dropped += 1
                    self._done += 1
                    if self._pooled:
                        # the assembler must skip this sequence
                        self._results[seq] = _DROPPED
            self._q.append((self._submitted, snap, label))
            self._submitted += 1
            self._cv.notify_all()

    def submit_recorder(self, recorder, label: Optional[str] = None) -> None:
        """Freeze + reset the recorder's live window and enqueue it — the
        async counterpart of ``AnalysisSession.ingest_recorder``."""
        self.submit(recorder.reset_window(), label=label)

    # -- synchronization -----------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> SessionReport:
        """Wait until every window submitted so far is analyzed (dropped
        windows count as handled), then return the session report."""
        with self._cv:
            target = self._submitted
            if not self._cv.wait_for(lambda: self._done >= target,
                                     timeout=timeout):
                raise TimeoutError(
                    f"drain timed out with {target - self._done} window(s) "
                    f"outstanding")
            self._raise_pending()
        return self._session.report()

    def close(self, timeout: Optional[float] = None) -> SessionReport:
        """Drain, stop the workers, and return the final report.  Idempotent;
        the backlog is fully analyzed before the workers exit."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        report = self.drain(timeout)
        for t in self._threads:
            t.join(timeout)
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True)
        if self._journal is not None:
            self._journal.close()
        return report

    def __enter__(self) -> "AsyncAnalysisSession":
        return self

    def __exit__(self, *exc) -> None:
        # on an exception unwind, still stop the workers but let the original
        # error surface rather than a secondary drain failure
        try:
            self.close(timeout=None if exc[0] is None else 5.0)
        except Exception:
            if exc[0] is None:
                raise

    # -- policy actions ------------------------------------------------------
    def take_actions(self) -> List:
        """Collect (and clear) the policy actions fired since the last call.
        ``drain()`` is the synchronization point: after it returns, this
        holds every action from every window submitted before the drain.
        Safe from any thread; the step loop typically polls it per window
        to apply rebalance weights / resharding."""
        with self._cv:
            out, self._actions = self._actions, []
        return out

    @property
    def policy_log(self):
        """The attached engine's :class:`~repro.core.policy.PolicyLog`
        (``None`` without an engine).  The log is appended on the worker
        threads — read it inside ``on_window`` or after ``drain``/``close``."""
        return self._engine.log if self._engine is not None else None

    # -- introspection -------------------------------------------------------
    @property
    def session(self) -> AnalysisSession:
        """The wrapped session — safe to touch only after ``close()``."""
        return self._session

    @property
    def workers(self) -> int:
        """Size of the analysis worker pool."""
        return self._workers_n

    @property
    def pending(self) -> int:
        """Windows queued but not yet claimed (bounded by ``max_queue``)."""
        with self._cv:
            return len(self._q)

    @property
    def dropped(self) -> int:
        """Windows evicted under the ``drop_oldest`` policy."""
        with self._cv:
            return self._dropped

    @property
    def submitted(self) -> int:
        with self._cv:
            return self._submitted

    @property
    def analyzed(self) -> int:
        """Windows actually ingested (excludes drops and failed ingests)."""
        with self._cv:
            return self._done - self._dropped - self._failed

    @property
    def failed(self) -> int:
        """Windows whose analysis raised (tombstoned under supervision).
        Invariant after ``drain``: analyzed + failed + dropped == submitted."""
        with self._cv:
            return self._failed

    @property
    def worker_restarts(self) -> int:
        """Single-worker threads replaced after a contained failure."""
        with self._cv:
            return self._restarts

    @property
    def journal_errors(self) -> int:
        """Journal appends that failed and were swallowed (counted only)."""
        with self._cv:
            return self._journal_errors
