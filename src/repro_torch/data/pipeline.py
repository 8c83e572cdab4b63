"""Deterministic synthetic token pipeline with host-I/O accounting and a
live, repartitionable per-host batch partition.

Produces next-token-prediction batches from a counter-seeded hash stream, so
any (step, shard) pair regenerates identical data — which is what makes the
checkpoint/restart contract exact: the iterator state is just the step
index (plus, when partitioned, the current :class:`Partition` weights).
Host-side byte counts feed perfdbg's ``disk_io`` attribute (the paper's
operating-system-layer metric).

The :class:`Partition` is the actuation surface of the closed
detect -> optimize loop: a fired rebalance/reshard action calls
``set_partition`` on the live pipeline, and from the next step on every
global batch is sliced by the new weights.  The partition is part of
``state_dict()`` so a repartition survives checkpoint/restore.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np


class Partition:
    """Per-host batch-slice weights over a global batch of B rows.

    Weights are stored normalized (they sum to 1); ``counts(batch)``
    apportions the B rows deterministically by largest remainder, and —
    provided ``batch >= n_hosts`` — guarantees every host at least one row,
    so no host silently drops out of the pod under an extreme skew.
    """

    __slots__ = ("weights",)

    def __init__(self, weights: Sequence[float]):
        w = np.asarray(weights, dtype=np.float64)
        if w.ndim != 1 or w.size == 0:
            raise ValueError("partition weights must be a non-empty 1-D "
                             f"sequence, got shape {w.shape}")
        if not np.all(np.isfinite(w)) or np.any(w < 0):
            raise ValueError(f"partition weights must be finite and >= 0, "
                             f"got {w.tolist()}")
        total = w.sum()
        if total <= 0:
            raise ValueError("partition weights must not all be zero")
        self.weights = w / total

    @classmethod
    def uniform(cls, n_hosts: int) -> "Partition":
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        return cls(np.ones(n_hosts))

    @property
    def n_hosts(self) -> int:
        return int(self.weights.size)

    def counts(self, batch: int) -> np.ndarray:
        """Integer rows per host: largest-remainder apportionment (floors,
        then +1 to the largest fractional parts; ties break toward the
        lower host index), preserving ``counts.sum() == batch`` exactly.
        When ``batch >= n_hosts`` every host gets >= 1 row (rows are moved
        from the largest allocation, lowest index first)."""
        if batch < 0:
            raise ValueError("batch must be >= 0")
        ideal = self.weights * batch
        base = np.floor(ideal).astype(np.int64)
        frac = ideal - base
        # lexsort: last key is primary -> order by descending fraction,
        # then ascending host index (deterministic tie-break)
        order = np.lexsort((np.arange(self.n_hosts), -frac))
        base[order[:batch - int(base.sum())]] += 1
        if batch >= self.n_hosts:
            while True:
                empty = np.flatnonzero(base == 0)
                if not empty.size:
                    break
                base[int(np.argmax(base))] -= 1    # argmax: first maximum
                base[int(empty[0])] += 1
        return base

    def bounds(self, batch: int) -> List[Tuple[int, int]]:
        """Contiguous, order-preserving row ranges [(start, stop), ...] —
        host h's slice of the global batch."""
        edges = np.concatenate(([0], np.cumsum(self.counts(batch))))
        return [(int(edges[h]), int(edges[h + 1]))
                for h in range(self.n_hosts)]

    # -- checkpointable state -----------------------------------------------
    def to_state(self) -> List[float]:
        """JSON-safe form for the checkpoint manifest."""
        return [float(w) for w in self.weights]

    @classmethod
    def from_state(cls, state: Sequence[float]) -> "Partition":
        return cls(state)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Partition)
                and np.array_equal(self.weights, other.weights))

    def __repr__(self) -> str:
        return f"Partition({np.round(self.weights, 4).tolist()})"


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    bytes_read: int = 0
    host_bytes: List[int] = dataclasses.field(default_factory=list)


class SyntheticTokens:
    """Deterministic LM batches: {"tokens": (B, S) int32, "labels": (B, S)}.

    With a :class:`Partition` attached (``set_partition``), ``split``
    slices each global batch into per-host views and accounts each host's
    real bytes read; ``set_partition`` mid-stream repartitions the *next*
    batch — the actuation path a fired policy takes."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 prefetch: int = 2,
                 partition: Optional[Partition] = None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.state = PipelineState()
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._prefetch = prefetch
        self._partition: Optional[Partition] = None
        if partition is not None:
            self.set_partition(partition)

    # -- partition (the live actuation surface) -----------------------------
    @property
    def partition(self) -> Optional[Partition]:
        return self._partition

    def set_partition(self,
                      partition: Union[Partition, Sequence[float], None]
                      ) -> None:
        """Attach / replace / drop the per-host partition.  Takes effect at
        the next ``split`` — the prefetch worker only ever produces global
        batches, so a live repartition never races batch generation.  The
        per-host byte counters reset only when the host count changes."""
        if partition is not None and not isinstance(partition, Partition):
            partition = Partition(partition)
        self._partition = partition
        n = 0 if partition is None else partition.n_hosts
        if len(self.state.host_bytes) != n:
            self.state.host_bytes = [0] * n

    def split(self, batch: Dict[str, np.ndarray]
              ) -> List[Dict[str, np.ndarray]]:
        """Slice one global batch into per-host views under the current
        partition (row ranges from ``Partition.bounds``; concatenating the
        slices in order reconstructs the batch exactly).  Accounts each
        host's real bytes into ``state.host_bytes``.  Without a partition:
        the single-host identity split."""
        if self._partition is None:
            return [batch]
        rows = len(next(iter(batch.values())))
        out = []
        for h, (lo, hi) in enumerate(self._partition.bounds(rows)):
            sl = {k: v[lo:hi] for k, v in batch.items()}
            self.state.host_bytes[h] += sum(int(v.nbytes)
                                            for v in sl.values())
            out.append(sl)
        return out

    def host_batch_at(self, step: int, host: int) -> Dict[str, np.ndarray]:
        """Host ``host``'s slice of the step-``step`` global batch under the
        current partition — pure (no byte accounting), deterministic per
        (step, host): the same global batch sliced by the same bounds."""
        if self._partition is None:
            if host != 0:
                raise IndexError("unpartitioned pipeline has only host 0")
            return self.batch_at(step)
        b = self.batch_at(step)
        lo, hi = self._partition.bounds(self.batch)[host]
        return {k: v[lo:hi] for k, v in b.items()}

    # -- deterministic generation -------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        toks = rng.integers(0, self.vocab_size,
                            size=(self.batch, self.seq + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        self.state.bytes_read += b["tokens"].nbytes + b["labels"].nbytes
        return b

    # -- prefetch (overlap host data with device compute) -------------------
    def start_prefetch(self) -> None:
        if self._thread is not None:
            return
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def worker(start_step: int, q: queue.Queue = q,
                   stop: threading.Event = stop):
            # the queue and stop event are captured locally: a worker from a
            # superseded prefetch generation can never push into (or poll)
            # its successor's queue, even if it outlives stop_prefetch()
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.2)
                    s += 1
                except queue.Full:
                    continue

        self._q, self._stop = q, stop
        self._thread = threading.Thread(target=worker,
                                        args=(self.state.step,), daemon=True)
        self._thread.start()

    def next_prefetched(self) -> Dict[str, np.ndarray]:
        if self._q is None:
            return next(self)
        b = self._q.get()
        self.state.step += 1
        self.state.bytes_read += b["tokens"].nbytes + b["labels"].nbytes
        return b

    def stop_prefetch(self) -> None:
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join()             # the old worker is gone before we return —
            self._thread = None  # a restart can never receive stale batches
            self._q = None
            self._stop = None

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """JSON-safe (manifest-ready) state: step, cumulative bytes, the
        current partition weights (or None), per-host byte counters."""
        return {"step": self.state.step,
                "bytes_read": self.state.bytes_read,
                "partition": (None if self._partition is None
                              else self._partition.to_state()),
                "host_bytes": [int(b) for b in self.state.host_bytes]}

    def load_state_dict(self, d: Dict[str, object]) -> None:
        was_prefetching = self._thread is not None
        self.stop_prefetch()
        part = d.get("partition")
        self.set_partition(None if part is None
                           else Partition.from_state(part))
        self.state = PipelineState(int(d["step"]),
                                   int(d.get("bytes_read", 0)),
                                   [int(b) for b in d.get("host_bytes", [])])
        if self._partition is not None and \
                len(self.state.host_bytes) != self._partition.n_hosts:
            self.state.host_bytes = [0] * self._partition.n_hosts
        if was_prefetching:
            self.start_prefetch()
