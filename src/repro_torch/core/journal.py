"""Crash-safe window journal: the durability half of the always-on service
(core layer: stdlib file IO only — no jax, no transport).

``AsyncAnalysisSession`` analyzes windows on worker threads; if the process
dies mid-run, every window still in flight — and the whole accumulated
timeline — is gone.  :class:`WindowJournal` closes that hole with an
append-only on-disk log of each *submitted* window's serialized snapshot
(``WindowSnapshot.to_bytes``) keyed by its submission sequence.  Recovery
(:func:`replay`) feeds the journaled blobs, in sequence order, into a fresh
``AnalysisSession``; analysis is deterministic, so the recovered
``SessionReport.render()`` is byte-identical to what the crashed session
would have produced over the same windows.

Record layout (little-endian), one per ``append``::

    <4s magic "PDWJ"> <u8 seq> <u4 label-len> <u4 blob-len> <u4 crc32>
    <label utf-8> <blob>

The crc covers the packed seq/lengths plus label and blob, so a torn tail
(crash mid-write) or a bit-flipped record is detected: :func:`scan` stops
cleanly at the first damaged record and everything before it replays.  The
journal never re-serializes — the blob is stored verbatim, checksum trailer
and all.

Layering: this module imports ``repro.perfdbg.recorder`` lazily inside
:func:`replay` only (the same pattern as ``session.straggler_verdict``), so
``core`` stays import-clean of the collection layer.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

JOURNAL_MAGIC = b"PDWJ"
_REC_HEADER = struct.Struct("<4sQIII")   # magic, seq, label_len, blob_len, crc


class JournalError(RuntimeError):
    """A journal write failed (disk full, closed file, injected fault)."""


def _crc(seq: int, label: bytes, blob: bytes) -> int:
    head = struct.pack("<QII", seq, len(label), len(blob))
    return zlib.crc32(blob, zlib.crc32(label, zlib.crc32(head))) & 0xFFFFFFFF


class WindowJournal:
    """Append-only journal of submitted window blobs.

    ``sync=True`` fsyncs every record (each append survives a power cut);
    the default flushes to the OS only — enough for process-crash recovery,
    which is the failure mode the supervised pipeline contains.
    """

    def __init__(self, path: str, *, sync: bool = False):
        self.path = os.fspath(path)
        self.sync = sync
        self.appended = 0
        self._fh = open(self.path, "ab")

    def append(self, seq: int, blob: bytes,
               label: Optional[str] = None) -> None:
        """Durably record one submitted window.  Raises
        :class:`JournalError` on any write failure — callers that must
        survive a sick disk (the supervised pipeline) catch and count it;
        the analysis itself never depends on the journal."""
        lab = (label or "").encode("utf-8")
        rec = b"".join([
            _REC_HEADER.pack(JOURNAL_MAGIC, seq, len(lab), len(blob),
                             _crc(seq, lab, blob)),
            lab, blob,
        ])
        try:
            self._fh.write(rec)
            self._fh.flush()
            if self.sync:
                os.fsync(self._fh.fileno())
        except (OSError, ValueError) as e:
            raise JournalError(f"journal append failed: {e}") from e
        self.appended += 1

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass

    def __enter__(self) -> "WindowJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def scan(path: str) -> List[Tuple[int, Optional[str], bytes]]:
    """Read every intact record: ``[(seq, label, blob), ...]`` in file
    order.  Stops cleanly at the first torn or corrupt record (crash
    mid-write), so a recovering process replays exactly the committed
    prefix — never raises for tail damage."""
    out: List[Tuple[int, Optional[str], bytes]] = []
    try:
        data = open(path, "rb").read()
    except FileNotFoundError:
        return out
    pos = 0
    while pos + _REC_HEADER.size <= len(data):
        magic, seq, label_len, blob_len, crc = _REC_HEADER.unpack_from(
            data, pos)
        if magic != JOURNAL_MAGIC:
            break
        body = pos + _REC_HEADER.size
        end = body + label_len + blob_len
        if end > len(data):
            break                       # torn tail: record cut mid-write
        lab = data[body:body + label_len]
        blob = data[body + label_len:end]
        if _crc(seq, lab, blob) != crc:
            break                       # bit damage: stop at the bad record
        out.append((seq, lab.decode("utf-8") if lab else None, blob))
        pos = end
    return out


def replay(path: str, tree=None, session=None, **session_kw):
    """Rebuild an analysis session from a journal: every intact record's
    blob is deserialized and ingested in sequence order.  Returns the
    (fresh or passed-in) ``AnalysisSession``; render its ``report()`` for
    the byte-identical recovered timeline.

    ``tree`` reuses a local ``RegionTree`` (else it is rebuilt from the
    first blob's self-describing header); ``session_kw`` forwards to the
    ``AnalysisSession`` constructor when no ``session`` is passed."""
    from repro_torch.perfdbg.recorder import WindowSnapshot   # lazy: layering
    from .session import AnalysisSession

    records = sorted(scan(path), key=lambda r: r[0])
    for seq, label, blob in records:
        snap = WindowSnapshot.from_bytes(blob, tree=tree)
        if session is None:
            tree = snap.tree if tree is None else tree
            session = AnalysisSession(tree, **session_kw)
        session.ingest_snapshot(snap, label=label)
    if session is None:
        if tree is None:
            raise ValueError(f"journal {path!r} holds no intact records and "
                             "no tree/session was supplied")
        session = AnalysisSession(tree, **session_kw)
    return session
