"""Per-shard, per-region performance records — the paper's lightweight
data layout, schema-driven and windowed (perfdbg layer: collection only;
imports ``repro.core`` for types, never the launch drivers).

The paper's headline claim: for n code regions x m processes AutoAnalyzer
collects and analyzes at most **125*n*m bytes**, of which ~33% (the
application-layer timing fields) suffice to *locate* bottlenecks and the
rest is only consulted for root-cause analysis.  We mirror that contract
with a packed record generated from an :class:`AttributeSchema`
(``perfdbg.schema``); the default ``paper`` schema is a fixed 96-byte cell:

    locate fields  (32 B):  cpu_time  wall_time  cycles  instructions
    attribute fields (40 B): l1_miss_rate l2_miss_rate disk_io net_io instr_attr
    ids / pad      (24 B):  region_id  rank  flags  pad

32 / 96 = 33% — the same proportion the paper reports.

Collection is *windowed* for continuous analysis of long runs: ``snapshot()``
freezes the live window, ``reset_window()`` pushes it onto a bounded ring and
starts a fresh one.  Each window independently honours the byte budget, so a
streaming consumer (``repro.core.session.AnalysisSession``) never holds more
than 125*n*m bytes per window.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import struct
import zlib
from typing import Deque, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import Measurements, RegionTree

from .schema import (AttributeField, AttributeSchema, LOCATE_FIELDS as _LOCATE,
                     PAPER_BYTES_PER_CELL, PAPER_SCHEMA, SUM, WMEAN, get_schema)

LOCATE_FIELDS = _LOCATE

# Back-compat names: the paper schema's layout and attribute columns.
RECORD_DTYPE = PAPER_SCHEMA.dtype()
ATTR_FIELDS = PAPER_SCHEMA.attr_names
assert RECORD_DTYPE.itemsize == 96

# Snapshot wire format: fixed prefix + JSON header + raw payload.
#     <4s magic> <u2 version> <u4 header-length> <header json>
#     <program_wall: n_ranks * f8> <data: schema dtype, row-major>
# The header is O(1) per snapshot (not per cell), so shipping a window
# stays within the paper's 125*n*m contract up to a constant.
WIRE_MAGIC = b"PDWS"
WIRE_VERSION = 1
_WIRE_PREFIX = struct.Struct("<4sHI")

# Optional integrity trailer: ``to_bytes(checksum=True)`` appends
# ``<4s magic "PDWC"> <u4 crc32-of-preceding-bytes>``.  ``from_bytes``
# detects, verifies, and strips it; blobs without the trailer (every blob
# ever produced before the trailer existed, and the checked-in golden
# corpus) parse unchanged, so the default wire output is byte-identical.
CHECKSUM_MAGIC = b"PDWC"
_CHECKSUM_TRAILER = struct.Struct("<4sI")


class WireFormatError(ValueError):
    """Malformed, incompatible, or wrong-version snapshot bytes."""


class WireSkewError(WireFormatError):
    """A *well-formed* snapshot from an incompatible peer: unknown wire
    version, or a schema / region-tree fingerprint that does not match the
    local one.  Distinguished from plain :class:`WireFormatError` (bit-level
    corruption) so a lenient merge can count skewed and corrupt hosts
    separately — a version-skewed host needs a rollout fix, a corrupt one a
    transport fix."""


def _measurements(data: np.ndarray, program_wall: np.ndarray) -> Measurements:
    def field(name):
        return data[name].astype(np.float64)
    pw = np.asarray(program_wall, dtype=np.float64).copy()
    if not pw.any():
        pw = field("wall_time").sum(axis=1)
    return Measurements(cpu_time=field("cpu_time"), wall_time=field("wall_time"),
                        program_wall=pw, cycles=field("cycles"),
                        instructions=field("instructions"))


def _attributes(schema: AttributeSchema, data: np.ndarray) -> Dict[str, np.ndarray]:
    return {f.export_name: data[f.name].astype(np.float64)
            for f in schema.fields}


@dataclasses.dataclass(frozen=True)
class WindowSnapshot:
    """A frozen collection window: the packed record matrix plus per-rank
    program wall time.  Cheap to ship (``to_bytes()``) and self-describing
    enough for ``AnalysisSession`` to consume directly.

    ``rank_offset`` places a single-host shard inside the pod-wide rank
    space (host h covering global ranks [offset, offset + m)); it is 0 for
    a merged or single-host view.  ``gap_mask`` is set by
    :func:`merge_snapshots` on merged views: True rows are global ranks no
    shard covered (zero-filled)."""

    index: int
    schema: AttributeSchema
    tree: RegionTree
    data: np.ndarray             # (m, n) structured array, schema.dtype()
    program_wall: np.ndarray     # (m,)
    label: Optional[str] = None
    rank_offset: int = 0
    gap_mask: Optional[np.ndarray] = None   # (m,) bool; None = complete

    @property
    def n_ranks(self) -> int:
        return int(self.data.shape[0])

    def measurements(self) -> Measurements:
        return _measurements(self.data, self.program_wall)

    def attributes(self) -> Dict[str, np.ndarray]:
        return _attributes(self.schema, self.data)

    def attribute_roles(self) -> Dict[str, str]:
        """export name -> the schema's declared semantic role (see
        ``repro.core.roughset.ATTRIBUTE_ROLES``); consumers interpret
        rough-set cores through these instead of attribute names."""
        return self.schema.roles_by_export()

    def packed(self) -> bytes:
        return self.data.tobytes()

    @property
    def nbytes(self) -> int:
        return self.data.nbytes

    # -- wire format --------------------------------------------------------
    def to_bytes(self, rank_offset: Optional[int] = None, *,
                 checksum: bool = False) -> bytes:
        """Serialize for transport: versioned header (schema name + field
        spec, window index/label, rank offset, region-tree fingerprint and
        spec, gap list) followed by the packed payload.

        ``checksum=True`` appends the 8-byte ``PDWC`` crc32 trailer so the
        receiver can reject bit-level corruption; the default stays
        trailer-free so existing serialized blobs remain byte-identical."""
        off = self.rank_offset if rank_offset is None else int(rank_offset)
        header = {
            "schema": self.schema.name,
            "schema_fp": self.schema.fingerprint(),
            "schema_spec": self.schema.to_spec(),
            "index": int(self.index),
            "label": self.label,
            "rank_offset": off,
            "n_ranks": self.n_ranks,
            "n_regions": int(self.data.shape[1]),
            "tree_fp": self.tree.fingerprint(),
            "tree_spec": self.tree.to_spec(),
        }
        if self.gap_mask is not None:
            # an empty list still means "merged view, fully covered" — the
            # receiver must get an all-False mask back, not None
            header["gaps"] = np.flatnonzero(self.gap_mask).tolist()
        hdr = json.dumps(header, separators=(",", ":")).encode()
        frame = b"".join([
            _WIRE_PREFIX.pack(WIRE_MAGIC, WIRE_VERSION, len(hdr)), hdr,
            np.ascontiguousarray(self.program_wall, dtype="<f8").tobytes(),
            np.ascontiguousarray(self.data).tobytes(),
        ])
        if checksum:
            frame += _CHECKSUM_TRAILER.pack(CHECKSUM_MAGIC,
                                            zlib.crc32(frame) & 0xFFFFFFFF)
        return frame

    @classmethod
    def from_bytes(cls, blob: bytes, tree: Optional[RegionTree] = None
                   ) -> "WindowSnapshot":
        """Inverse of :meth:`to_bytes`.  The header is self-describing: the
        region tree and (if unregistered) the schema are rebuilt from their
        specs.  Pass ``tree`` to reuse a local instance — its fingerprint
        must match the one in the header."""
        if len(blob) < _WIRE_PREFIX.size:
            raise WireFormatError("snapshot blob truncated (no prefix)")
        magic, version, hlen = _WIRE_PREFIX.unpack_from(blob)
        if magic != WIRE_MAGIC:
            raise WireFormatError(f"bad magic {magic!r}")
        if version != WIRE_VERSION:
            raise WireSkewError(f"unsupported wire version {version} "
                                f"(expected {WIRE_VERSION})")
        body = _WIRE_PREFIX.size
        if (len(blob) >= body + _CHECKSUM_TRAILER.size
                and blob[-8:-4] == CHECKSUM_MAGIC):
            _, want = _CHECKSUM_TRAILER.unpack_from(blob, len(blob) - 8)
            if zlib.crc32(blob[:-8]) & 0xFFFFFFFF != want:
                raise WireFormatError(
                    "snapshot checksum mismatch: blob corrupted in transit")
            blob = blob[:-8]
        try:
            header = json.loads(blob[body:body + hlen])
        except ValueError as e:
            raise WireFormatError(f"bad snapshot header: {e}") from None
        try:
            schema = get_schema(header["schema"])
        except KeyError:
            schema = AttributeSchema.from_spec(header["schema"],
                                               header["schema_spec"])
        if schema.fingerprint() != header["schema_fp"]:
            raise WireSkewError(
                f"schema {header['schema']!r} layout mismatch: local "
                f"{schema.fingerprint()} != shipped {header['schema_fp']}")
        if tree is None:
            tree = RegionTree.from_spec(header["tree_spec"])
        if tree.fingerprint() != header["tree_fp"]:
            raise WireSkewError(
                f"region tree mismatch: local {tree.fingerprint()} != "
                f"shipped {header['tree_fp']}")
        m, n = header["n_ranks"], header["n_regions"]
        dt = schema.dtype()
        payload = blob[body + hlen:]
        if len(payload) != 8 * m + dt.itemsize * m * n:
            raise WireFormatError(
                f"payload is {len(payload)} bytes, expected "
                f"{8 * m + dt.itemsize * m * n} for {m} ranks x {n} regions")
        program_wall = np.frombuffer(payload[:8 * m], dtype="<f8").copy()
        data = np.frombuffer(payload[8 * m:], dtype=dt).reshape(m, n).copy()
        gaps = header.get("gaps")
        gap_mask = None
        if gaps is not None:
            gap_mask = np.zeros(m, dtype=bool)
            gap_mask[gaps] = True
        return cls(header["index"], schema, tree, data, program_wall,
                   header["label"], rank_offset=header["rank_offset"],
                   gap_mask=gap_mask)


def merge_snapshots(shards: Sequence[Optional[WindowSnapshot]],
                    total_ranks: Optional[int] = None) -> WindowSnapshot:
    """Concatenate per-host window shards into one pod-wide m-rank snapshot.

    Shards must agree on schema layout, region tree, and window index.  Rank
    placement has two modes:

    * **declared** — any shard carries a nonzero ``rank_offset``: each shard
      lands at its offset; overlaps raise.
    * **cumulative** — all offsets are 0: shards stack in list order.

    ``None`` entries are missing hosts.  Their ranks (cumulative mode infers
    the hole size only when all present shards are the same size) plus any
    ranks no shard covers up to ``total_ranks`` are zero-filled and flagged
    in the merged snapshot's ``gap_mask``.  The merged ``rank`` id column is
    rewritten to global rank ids."""
    present = [s for s in shards if s is not None]
    if not present:
        raise ValueError("merge_snapshots needs at least one present shard")
    ref = present[0]
    for s in present[1:]:
        if s.schema.fingerprint() != ref.schema.fingerprint():
            raise WireFormatError(
                f"shard schema {s.schema.name!r} incompatible with "
                f"{ref.schema.name!r}")
        if s.tree.fingerprint() != ref.tree.fingerprint():
            raise WireFormatError("shard region trees differ")
        if s.index != ref.index:
            raise WireFormatError(
                f"shard window indices differ: {s.index} != {ref.index}")
    declared = any(s.rank_offset != 0 for s in present)
    placed: list = []          # (offset, shard)
    if declared:
        placed = [(s.rank_offset, s) for s in present]
    else:
        sizes = {s.n_ranks for s in present}
        if len(present) != len(shards) and len(sizes) != 1:
            raise ValueError(
                "cannot infer the rank span of a missing shard: shards "
                "carry no rank_offset and present shards differ in size")
        hole = next(iter(sizes))
        off = 0
        for s in shards:
            if s is not None:
                placed.append((off, s))
            off += hole if s is None else s.n_ranks
    end = max(off + s.n_ranks for off, s in placed)
    if not declared:
        end = max(end, off)   # a trailing missing host still widens the pod
    m = end if total_ranks is None else int(total_ranks)
    if m < end:
        raise ValueError(f"total_ranks={m} smaller than shard coverage {end}")
    n = ref.data.shape[1]
    data = np.zeros((m, n), dtype=ref.data.dtype)
    data["region_id"] = ref.data["region_id"][:1]   # well-formed gap rows
    program_wall = np.zeros(m)
    gap = np.ones(m, dtype=bool)
    label = next((s.label for s in present if s.label is not None), None)
    for off, s in sorted(placed, key=lambda p: p[0]):
        if not gap[off:off + s.n_ranks].all():
            raise ValueError(f"shard rank ranges overlap at offset {off}")
        data[off:off + s.n_ranks] = s.data
        program_wall[off:off + s.n_ranks] = s.program_wall
        gap[off:off + s.n_ranks] = False
    data["rank"] = np.arange(m, dtype=data.dtype["rank"])[:, None]
    return WindowSnapshot(ref.index, ref.schema, ref.tree, data,
                          program_wall, label, rank_offset=0, gap_mask=gap)


class RegionRecorder:
    """Accumulates per-(rank, region) metrics for the live window and exports
    the matrices ``repro.core`` consumes.  ``schema`` selects the attribute
    set (a registered name or an :class:`AttributeSchema`).

    ``cost_provider`` optionally attaches a ``perfdbg.costs.CostProvider``:
    on every ``add``, schema fields with a declared ``provider_key`` that
    the call did not pass explicitly are pulled from the provider (one
    region execution's worth per add).  Precedence per field: explicit
    keyword > provider > ``source`` locate-field mirror."""

    def __init__(self, tree: RegionTree, n_ranks: int,
                 schema: Union[str, AttributeSchema] = "paper",
                 max_windows: int = 16, rank_offset: int = 0,
                 cost_provider=None):
        self.tree = tree
        self.n_ranks = n_ranks
        self.rank_offset = rank_offset
        self.schema = get_schema(schema) if isinstance(schema, str) else schema
        self.dtype = self.schema.dtype()
        self._cols: Dict[int, int] = {rid: i for i, rid in enumerate(tree.ids())}
        self._windows: Deque[WindowSnapshot] = collections.deque(
            maxlen=max_windows)
        self.window_index = 0
        self._provider = cost_provider
        self._provider_vals: Dict[int, Dict[str, float]] = {}
        self._init_window()

    def _init_window(self) -> None:
        n = len(self.tree)
        self._data = np.zeros((self.n_ranks, n), dtype=self.dtype)
        for rank in range(self.n_ranks):
            for rid, col in self._cols.items():
                self._data[rank, col]["region_id"] = rid
                self._data[rank, col]["rank"] = rank
        self.program_wall = np.zeros(self.n_ranks)
        # weights for WMEAN fields live outside the packed record: the record
        # stores the running mean itself, so the packed round-trip is exact.
        self._wmean_w = {f.name: np.zeros((self.n_ranks, n))
                         for f in self.schema.wmean_fields}

    # -- cost provider -------------------------------------------------------
    @property
    def cost_provider(self):
        return self._provider

    def attach_provider(self, provider) -> None:
        """Attach (or replace) the cost provider; the per-region value memo
        is dropped so the next ``add`` re-pulls fresh costs."""
        self._provider = provider
        self._provider_vals.clear()

    def _provider_values(self, region: int) -> Dict[str, float]:
        """Schema field name -> provider value for one region execution,
        memoized per region id (providers are pure; see costs.py)."""
        vals = self._provider_vals.get(region)
        if vals is None:
            costs = self._provider.region_costs(self.tree.name(region))
            vals = self.schema.values_from_provider(costs)
            self._provider_vals[region] = vals
        return vals

    # -- recording ---------------------------------------------------------
    def add(self, rank: int, region: int, *, cpu_time: float = 0.0,
            wall_time: float = 0.0, cycles: float = 0.0,
            instructions: float = 0.0, **attrs: Optional[float]) -> None:
        """Accumulate one observation.  Keyword attributes must belong to the
        recorder's schema; ``None`` values are skipped (field not measured
        this call).  SUM fields accumulate; WMEAN fields fold into a
        duration-weighted running mean (weight = wall time, falling back to
        CPU time, then 1).  With a cost provider attached, fields it covers
        are filled automatically (explicit keyword > provider > source
        mirror)."""
        cell = self._data[rank, self._cols[region]]
        cell["cpu_time"] += cpu_time
        cell["wall_time"] += wall_time
        cell["cycles"] += cycles
        cell["instructions"] += instructions
        locate = {"cpu_time": cpu_time, "wall_time": wall_time,
                  "cycles": cycles, "instructions": instructions}
        unknown = set(attrs) - set(self.schema.attr_names)
        if unknown:
            raise TypeError(f"unknown attribute(s) {sorted(unknown)} for "
                            f"schema {self.schema.name!r}")
        provided = self._provider_values(region) if self._provider else {}
        w = wall_time if wall_time > 0 else (cpu_time if cpu_time > 0 else 1.0)
        for f in self.schema.fields:
            val = attrs.get(f.name)
            if val is None:
                val = provided.get(f.name)
            if val is None and f.source is not None:
                val = locate[f.source]
            if val is None:
                continue
            if f.reduction == SUM:
                cell[f.name] += val
            else:  # WMEAN — Welford-style update: exact for constant values
                wp = self._wmean_w[f.name][rank, self._cols[region]]
                cell[f.name] += (val - cell[f.name]) * (w / (wp + w))
                self._wmean_w[f.name][rank, self._cols[region]] = wp + w

    def add_program_wall(self, rank: int, wall: float) -> None:
        self.program_wall[rank] += wall

    # -- windows -------------------------------------------------------------
    def snapshot(self, label: Optional[str] = None) -> WindowSnapshot:
        """Freeze the live window (no reset): one ≤125*n*m-byte copy, the
        only per-window cost a streaming loop pays on its critical path.
        The returned snapshot is immutable — later ``add`` calls never
        alias into it."""
        return WindowSnapshot(self.window_index, self.schema, self.tree,
                              self._data.copy(), self.program_wall.copy(),
                              label, rank_offset=self.rank_offset)

    def reset_window(self, label: Optional[str] = None) -> WindowSnapshot:
        """Push the live window onto the ring and start a fresh one.
        Returns the frozen window."""
        snap = self.snapshot(label)
        self._windows.append(snap)
        self.window_index += 1
        self._init_window()
        return snap

    def windows(self) -> Tuple[WindowSnapshot, ...]:
        """Frozen windows still in the ring (oldest first)."""
        return tuple(self._windows)

    # -- the 125*n*m contract ------------------------------------------------
    def packed(self) -> bytes:
        return self._data.tobytes()

    def packed_size(self) -> int:
        return self._data.nbytes

    def within_paper_budget(self) -> bool:
        n, m = len(self.tree), self.n_ranks
        return self.packed_size() <= PAPER_BYTES_PER_CELL * n * m

    @classmethod
    def from_packed(cls, tree: RegionTree, n_ranks: int, blob: bytes,
                    schema: Union[str, AttributeSchema] = "paper"
                    ) -> "RegionRecorder":
        rec = cls(tree, n_ranks, schema=schema)
        arr = np.frombuffer(blob, dtype=rec.dtype).reshape(n_ranks, len(tree))
        rec._data = arr.copy()
        # WMEAN weights accumulate wall time per add; reconstruct them from
        # the restored wall times so later adds fold into (not overwrite)
        # the shipped running means.  A zero stored mean is treated as
        # never-measured (weight 0) so unmeasured fields don't dilute later
        # adds toward a phantom 0.0 baseline.
        wall = rec._data["wall_time"].astype(np.float64)
        for f in rec.schema.wmean_fields:
            vals = rec._data[f.name].astype(np.float64)
            rec._wmean_w[f.name] = np.where(vals != 0.0, wall, 0.0)
        return rec

    # -- export -------------------------------------------------------------
    def measurements(self) -> Measurements:
        return _measurements(self._data, self.program_wall)

    def attributes(self) -> Dict[str, np.ndarray]:
        return _attributes(self.schema, self._data)

    def attribute_roles(self) -> Dict[str, str]:
        """export name -> declared semantic role (see WindowSnapshot)."""
        return self.schema.roles_by_export()

    def analyze(self):
        """Single-window analysis of the live window (does not reset)."""
        from repro_torch.core.session import AnalysisSession
        return AnalysisSession(self.tree).ingest_snapshot(
            self.snapshot()).report
