"""Pod-wide snapshot collection (launch layer: transport over perfdbg blobs).

Counterpart of ``repro/launch/collect.py``.  Each host of a pod records
only its own shard of the ranks; the paper's analysis needs the single view
of all m processes.  Every host serializes its ``WindowSnapshot``
(``to_bytes``, rank offset stamped into the header) and the blobs are
allgathered and merged into one m-rank snapshot.

Two layers, so the merge logic is testable without a pod:

* :func:`merge_blobs` — pure bytes in, merged snapshot out (numpy; its
  source and :class:`TransportHealth`'s are the reference's).
* :class:`SnapshotCollector` — the transport, over the default
  ``torch.distributed`` process group: two all-gathers, the sizes and
  then the max-padded uint8 payloads, on the current CUDA device under
  NCCL and on the CPU under gloo.  With no group initialised it is one
  process and merges its own shard locally (same code path).

Resilience: a host that cannot produce its shard ships an **empty payload**
instead of stalling the pod.  ``gather`` accepts ``snap=None`` (nothing to
contribute), and ``gather_timed`` bounds the time spent *producing* the
local snapshot — on timeout the host still joins the collective (it must:
an all-gather is cooperative) but contributes nothing, and its ranks appear
in the merged snapshot's ``gap_mask``.  Downstream, straggler analysis
treats gap-masked ranks as *missing* (never "fast") and
``core.policy.CollectorQuarantinePolicy`` flags hosts that stay gone.

Importing this module touches no device and no process group; torch's
distributed package is reached inside the collector's methods only.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional, Sequence

from repro_torch.perfdbg.recorder import (WindowSnapshot, WireFormatError,
                                          WireSkewError, merge_snapshots)


class TransportHealth:
    """Cumulative per-host transport counters, fed by every lenient
    :func:`merge_blobs` call (and by :class:`SnapshotCollector` for local
    production failures).  One instance outlives many windows, so streak
    consumers (``core.policy.CollectorQuarantinePolicy``) see a host that
    *alternates* good and corrupt windows accumulate a corruption count
    even though its gap streak keeps resetting.

    Per-host counters (dicts keyed by host index):

    * ``ok``      — blob parsed and merged cleanly
    * ``missing`` — host shipped nothing (timeout, dropout, empty payload)
    * ``corrupt`` — blob failed parse/checksum (bit-level damage)
    * ``skew``    — well-formed blob from an incompatible peer (wire
      version, schema/tree fingerprint, or window-index mismatch)

    Collector-side scalars: ``local_failures`` (local snapshot production
    gave up after retries), ``retries`` (failed attempts that were
    retried), ``abandoned`` (windows skipped because the previous producer
    thread was still wedged — the pileup guard).
    """

    STATUSES = ("ok", "missing", "corrupt", "skew")

    def __init__(self) -> None:
        self.ok: Dict[int, int] = collections.Counter()
        self.missing: Dict[int, int] = collections.Counter()
        self.corrupt: Dict[int, int] = collections.Counter()
        self.skew: Dict[int, int] = collections.Counter()
        self.local_failures = 0
        self.retries = 0
        self.abandoned = 0
        self.windows = 0
        self.last_statuses: Dict[int, str] = {}

    def observe(self, statuses: Sequence[str]) -> None:
        """Record one merge's per-host outcome (index = host position)."""
        self.windows += 1
        for host, status in enumerate(statuses):
            getattr(self, status)[host] += 1
            self.last_statuses[host] = status

    def bad(self, host: int) -> int:
        """Windows where ``host`` shipped damaged or incompatible bytes
        (corrupt + skew) — the quarantine policy's input."""
        return self.corrupt[host] + self.skew[host]

    def hosts(self) -> Sequence[int]:
        seen = set()
        for c in (self.ok, self.missing, self.corrupt, self.skew):
            seen.update(c)
        return sorted(seen)

    def render(self) -> str:
        lines = [f"transport health: {self.windows} windows, "
                 f"{self.local_failures} local failures, "
                 f"{self.retries} retries, {self.abandoned} abandoned"]
        for h in self.hosts():
            lines.append(f"  host {h}: ok={self.ok[h]} "
                         f"missing={self.missing[h]} corrupt={self.corrupt[h]} "
                         f"skew={self.skew[h]}")
        return "\n".join(lines)


def merge_blobs(blobs: Sequence[Optional[bytes]], tree=None,
                total_ranks: Optional[int] = None, *, strict: bool = True,
                health: Optional[TransportHealth] = None) -> WindowSnapshot:
    """Deserialize per-host snapshot blobs and merge into one pod view.
    ``None`` or empty entries are missing hosts (their ranks gap-mask).
    The pure-bytes fallback path: what :class:`SnapshotCollector` does after
    transport, minus the transport.

    ``strict=False`` quarantines instead of raising: a blob that fails
    parse or checksum (corrupt), carries an unknown wire version or
    mismatched schema/tree fingerprint (skew), or disagrees with its peers
    on window index is dropped and its ranks join the merged ``gap_mask``
    exactly as if the host had shipped nothing.  Pass ``health`` to
    accumulate the per-host outcome counters.  Only the no-usable-shard
    case still raises (``ValueError`` from :func:`merge_snapshots`) — there
    is no window to analyze."""
    shards: list = []
    statuses: list = []
    for b in blobs:
        if not b:
            shards.append(None)
            statuses.append("missing")
            continue
        try:
            shards.append(WindowSnapshot.from_bytes(b, tree=tree))
            statuses.append("ok")
        except WireSkewError:
            if strict:
                raise
            shards.append(None)
            statuses.append("skew")
        except WireFormatError:
            if strict:
                raise
            shards.append(None)
            statuses.append("corrupt")
    if not strict:
        # cross-shard agreement: peers that parsed fine individually but
        # disagree with the first usable shard are skewed, not corrupt
        ref = next((s for s in shards if s is not None), None)
        for i, s in enumerate(shards):
            if s is None or s is ref:
                continue
            if (s.schema.fingerprint() != ref.schema.fingerprint()
                    or s.tree.fingerprint() != ref.tree.fingerprint()
                    or s.index != ref.index):
                shards[i] = None
                statuses[i] = "skew"
    if health is not None:
        health.observe(statuses)
    return merge_snapshots(shards, total_ranks=total_ranks)


class SnapshotCollector:
    """Gathers one ``WindowSnapshot`` per host into the pod-wide view.

    ``rank_offset`` places this host's shard in the global rank space;
    by default host h with an m-rank local shard covers ranks
    [h*m, (h+1)*m) — the usual contiguous per-host layout.

    ``timeout`` (seconds) bounds local snapshot *production* in
    :meth:`gather_timed`; the collective itself is cooperative and cannot
    abandon a host mid-allgather.

    Hardening knobs (all default to the historical behavior):

    * ``retries``/``backoff`` — a ``snapshot_fn`` that raises is retried up
      to ``retries`` times with deterministic exponential backoff
      (``backoff * 2**attempt`` seconds); when attempts are exhausted the
      host ships ``None`` (its ranks gap-mask) instead of crashing the
      step loop.
    * ``strict=False`` — merge leniently (see :func:`merge_blobs`):
      corrupt or version-skewed peer blobs are quarantined into the gap
      mask, never a pod-wide raise.
    * ``health`` — a :class:`TransportHealth` accumulating per-host
      outcomes plus this host's retry/abandon counters.

    Serialized shards always carry the ``PDWC`` checksum trailer, so a
    receiving host can tell bit-level transport damage from a
    well-formed-but-incompatible peer.
    """

    def __init__(self, rank_offset: Optional[int] = None,
                 timeout: Optional[float] = None, *, retries: int = 0,
                 backoff: float = 0.05, strict: bool = True,
                 health: Optional[TransportHealth] = None):
        self._rank_offset = rank_offset
        self.timeout = timeout
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.strict = strict
        self.health = health
        self._producer: Optional[threading.Thread] = None

    @property
    def process_index(self) -> int:
        """This process's rank in the default group (0 without one)."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    @property
    def process_count(self) -> int:
        """The default group's size (1 without one)."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    def gather(self, snap: Optional[WindowSnapshot],
               total_ranks: Optional[int] = None) -> WindowSnapshot:
        """Allgather this host's shard with every other host's and merge.
        Every host returns the same merged m-rank snapshot.

        ``snap=None`` means this host has nothing to contribute (e.g. its
        snapshot timed out): it ships an empty payload, still participates
        in the collective, and its ranks appear in the merged ``gap_mask``
        (pass ``total_ranks`` so the merge knows the pod width).  If *no*
        host contributed, there is nothing to merge and a ``ValueError``
        surfaces from :func:`merge_snapshots`."""
        if snap is None:
            blob, tree = b"", None
        else:
            off = self._rank_offset if self._rank_offset is not None \
                else self.process_index * snap.n_ranks
            blob = snap.to_bytes(rank_offset=off, checksum=True)
            tree = snap.tree
        if self.process_count == 1:
            return merge_blobs([blob], tree=tree, total_ranks=total_ranks,
                               strict=self.strict, health=self.health)
        return merge_blobs(self._allgather(blob), tree=tree,
                           total_ranks=total_ranks, strict=self.strict,
                           health=self.health)

    def gather_timed(self, snapshot_fn: Callable[[], WindowSnapshot],
                     total_ranks: Optional[int] = None) -> WindowSnapshot:
        """Produce the local shard with ``snapshot_fn()`` under the
        collector's ``timeout``, then :meth:`gather` it.  A host whose
        snapshot is not ready in time ships ``None`` — the pod is never
        blocked by one wedged recorder, and the window arrives with that
        host's ranks gap-masked.

        The abandoned producer thread is a daemon whose late *result* is
        discarded — but its side effects are not.  ``snapshot_fn`` must
        therefore be a pure freeze (``recorder.snapshot``), never a
        mutation like ``recorder.reset_window``: a late reset would race
        the next window's recording.

        Pileup guard: if the producer abandoned on a *previous* window is
        still wedged, no new producer is spawned — this window ships
        ``None`` immediately and ``health.abandoned`` counts it.  One stuck
        recorder therefore costs one thread, not one thread per window."""
        if self.timeout is None and self.retries == 0:
            return self.gather(snapshot_fn(), total_ranks=total_ranks)
        if self._producer is not None and self._producer.is_alive():
            if self.health is not None:
                self.health.abandoned += 1
            return self.gather(None, total_ranks=total_ranks)
        self._producer = None
        if self.timeout is None:
            return self.gather(self._produce(snapshot_fn),
                               total_ranks=total_ranks)
        box: list = []
        worker = threading.Thread(
            target=lambda: box.append(self._produce(snapshot_fn)),
            daemon=True)
        worker.start()
        worker.join(self.timeout)
        if worker.is_alive():
            self._producer = worker   # remember it: the pileup guard's input
            snap = None
        else:
            snap = box[0] if box else None
        return self.gather(snap, total_ranks=total_ranks)

    def _produce(self, snapshot_fn: Callable[[], WindowSnapshot]
                 ) -> Optional[WindowSnapshot]:
        """Run ``snapshot_fn`` with the retry/backoff schedule.  Returns
        ``None`` (ship nothing, gap-mask this host) once attempts are
        exhausted — a local measurement failure must never take down the
        pod-wide collective."""
        for attempt in range(self.retries + 1):
            try:
                return snapshot_fn()
            except Exception:
                if attempt >= self.retries:
                    if self.health is not None:
                        self.health.local_failures += 1
                    return None
                if self.health is not None:
                    self.health.retries += 1
                time.sleep(self.backoff * (2 ** attempt))
        return None

    def _allgather(self, blob: bytes) -> list:
        """Ship variable-length blobs via two fixed-shape all-gathers:
        sizes first, then the max-size-padded payloads.  A zero-size entry
        is a host that contributed nothing and comes back as ``None``.

        The tensors live where the group's backend moves them: on
        ``torch.cuda.current_device()`` under NCCL, on the CPU under gloo;
        any other backend raises."""
        import torch
        import torch.distributed as dist
        backend = str(dist.get_backend()).lower()
        if backend == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        elif backend == "gloo":
            device = torch.device("cpu")
        else:
            raise RuntimeError(f"SnapshotCollector moves blobs over nccl (on "
                               f"the card) or gloo (on the CPU), not over "
                               f"the {backend!r} backend")
        world = dist.get_world_size()
        local = torch.frombuffer(bytearray(blob), dtype=torch.uint8) \
            if blob else torch.zeros(0, dtype=torch.uint8)
        size = torch.tensor([local.numel()], dtype=torch.int64, device=device)
        sizes = [torch.zeros_like(size) for _ in range(world)]
        dist.all_gather(sizes, size)
        sizes = [int(t.item()) for t in sizes]
        padded = torch.zeros(max(max(sizes), 1), dtype=torch.uint8,
                             device=device)
        padded[:local.numel()] = local.to(device)
        stacked = [torch.zeros_like(padded) for _ in range(world)]
        dist.all_gather(stacked, padded)
        return [stacked[i][:sizes[i]].cpu().numpy().tobytes() if sizes[i]
                else None for i in range(world)]
