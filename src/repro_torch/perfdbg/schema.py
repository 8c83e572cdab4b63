"""Schema-driven metric records (the paper's 125*n*m contract, generalized).

The original paper fixes five PAPI attributes; the follow-up work (arXiv
1103.6087) generalizes the attribute set.  An :class:`AttributeSchema` names
the root-cause attribute fields collected next to the fixed *locate* fields
(cpu_time / wall_time / cycles / instructions — the ~33% of the record that
suffices to locate bottlenecks) and generates the packed ``np.dtype`` for
``RegionRecorder``.

Two schemas ship built in:

    ``paper``  — the five PAPI-era attributes (L1/L2 miss rate, disk I/O,
                 network I/O, instruction count).
    ``tpu``    — the roofline-derived set from ``perfdbg.attributes``
                 (vmem pressure, HBM boundedness, host-I/O bytes,
                 collective bytes, HLO flops).

Every registered schema is checked against the paper's byte budget: a packed
cell may not exceed :data:`PAPER_BYTES_PER_CELL` (125) bytes, so a full
collection stays within 125*n*m bytes for n regions x m processes.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.roughset import (ROLE_IO, ROLE_MEMORY, ROLE_NETWORK,
                                 ROLE_WORK)

PAPER_BYTES_PER_CELL = 125

#: Fixed locate fields — the application-layer timing block the paper uses to
#: *locate* bottlenecks (about a third of the record).
LOCATE_FIELDS = ("cpu_time", "wall_time", "cycles", "instructions")

#: Field reductions: how repeated ``add`` calls on the same (rank, region)
#: cell combine.
SUM = "sum"      # plain accumulation (bytes, counts)
WMEAN = "wmean"  # duration-weighted running mean (rates / ratios)


@dataclasses.dataclass(frozen=True)
class AttributeField:
    """One root-cause attribute column of the packed record.

    ``reduction`` selects accumulation semantics (SUM or WMEAN).  ``source``
    optionally names a locate field whose value feeds this attribute
    automatically on every ``add`` (e.g. the paper's ``instr_attr`` mirror of
    the ``instructions`` locate field), unless an explicit value is given.
    ``export`` is the name under which the field appears in
    ``RegionRecorder.attributes()`` (defaults to ``name``).

    ``provider_key`` names the key under which an attached
    :class:`~repro.perfdbg.costs.CostProvider` reports this field's
    per-execution value (``None`` = never provider-fed); ``role`` declares
    the field's semantic role from :data:`repro.core.roughset.
    ATTRIBUTE_ROLES`, which downstream consumers (policies, verdicts) read
    instead of hardcoding attribute names.  Neither changes the packed
    bytes, so both are excluded from the layout fingerprint (provider-fed
    and kwargs-fed shards are wire-compatible).  ``role`` DOES ship in the
    wire spec — a receiving analysis host interprets cores through it —
    while ``provider_key`` stays collection-side only.
    """

    name: str
    reduction: str = SUM
    source: Optional[str] = None
    export: Optional[str] = None
    provider_key: Optional[str] = None
    role: Optional[str] = None

    def __post_init__(self):
        if self.reduction not in (SUM, WMEAN):
            raise ValueError(f"unknown reduction {self.reduction!r}")
        if self.source is not None and self.source not in LOCATE_FIELDS:
            raise ValueError(f"source must be a locate field, got {self.source!r}")

    @property
    def export_name(self) -> str:
        return self.export or self.name


@dataclasses.dataclass(frozen=True)
class AttributeSchema:
    """Named attribute set + generated packed record layout."""

    name: str
    fields: Tuple[AttributeField, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate attribute field in schema {self.name!r}")
        if set(names) & set(LOCATE_FIELDS):
            raise ValueError("attribute fields may not shadow locate fields")
        exports = [f.export_name for f in self.fields]
        if len(set(exports)) != len(exports):
            raise ValueError(f"duplicate export name in schema {self.name!r}: "
                             f"a column would be silently overwritten")

    # -- layout -------------------------------------------------------------
    def dtype(self) -> np.dtype:
        """Packed per-(rank, region) record: locate block, attribute block,
        id block, padded so the locate block is <= 1/3 of the record (the
        paper reports locating needs only ~33% of the collected bytes)."""
        entries = [(f, "<f8") for f in LOCATE_FIELDS]
        entries += [(f.name, "<f8") for f in self.fields]
        entries += [("region_id", "<u2"), ("rank", "<u4"), ("flags", "<u2")]
        raw = sum(np.dtype(t).itemsize for _, t in entries)
        locate_bytes = 8 * len(LOCATE_FIELDS)
        pad = max(0, 3 * locate_bytes - raw)
        if pad:
            entries.append(("_pad", f"<V{pad}"))
        dt = np.dtype(entries)
        return dt

    def bytes_per_cell(self) -> int:
        return self.dtype().itemsize

    def fingerprint(self) -> str:
        """Stable digest of the schema's identity *and* packed layout.  Two
        schemas with the same name but different fields/reductions get
        different fingerprints, so snapshot transport can reject a shard
        packed under a stale schema definition.  ``provider_key``/``role``
        are excluded on purpose: how a cell was *filled* does not change
        what its bytes mean, so provider-fed and kwargs-fed shards stay
        wire-compatible."""
        spec = [self.name, str(self.dtype().descr)]
        spec += [(f.name, f.reduction, f.source, f.export_name)
                 for f in self.fields]
        return hashlib.sha256(repr(spec).encode()).hexdigest()[:16]

    def to_spec(self) -> list:
        """JSON-serializable field spec (for self-describing wire headers).
        Roles ship (a receiver's policies interpret cores through them);
        ``provider_key`` does not (pulling from a provider is strictly a
        collection-side act — a receiver only ever reads recorded cells).
        The role entry is additive: it is excluded from :meth:`fingerprint`
        and ``from_spec`` accepts role-less (pre-role) specs, so old blobs
        stay readable."""
        return [[f.name, f.reduction, f.source, f.export, f.role]
                for f in self.fields]

    @classmethod
    def from_spec(cls, name: str, spec) -> "AttributeSchema":
        return cls(name, tuple(
            AttributeField(e[0], e[1], e[2], e[3],
                           role=e[4] if len(e) > 4 else None)
            for e in spec))

    def within_budget(self) -> bool:
        """The paper's headline contract, per cell: <= 125 bytes."""
        return self.bytes_per_cell() <= PAPER_BYTES_PER_CELL

    # -- field views ---------------------------------------------------------
    @property
    def attr_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    @property
    def export_names(self) -> Tuple[str, ...]:
        return tuple(f.export_name for f in self.fields)

    @property
    def wmean_fields(self) -> Tuple[AttributeField, ...]:
        return tuple(f for f in self.fields if f.reduction == WMEAN)

    @property
    def provider_fields(self) -> Tuple[AttributeField, ...]:
        """Fields an attached cost provider may fill (provider_key set)."""
        return tuple(f for f in self.fields if f.provider_key is not None)

    def values_from_provider(self, costs: Mapping[str, float]
                             ) -> Dict[str, float]:
        """Map one region's provider costs (``region_costs`` output, keyed
        by provider key) onto this schema's field names.  Keys no field
        declares are ignored — a provider may report more terms than a
        given schema records."""
        return {f.name: float(costs[f.provider_key])
                for f in self.provider_fields if f.provider_key in costs}

    def roles_by_export(self) -> Dict[str, str]:
        """export name -> declared semantic role, for fields that have one
        (the mapping snapshots carry to the analysis layer)."""
        return {f.export_name: f.role for f in self.fields
                if f.role is not None}

    def field(self, name: str) -> AttributeField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"schema {self.name!r} has no attribute field {name!r}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, AttributeSchema] = {}


def register_schema(schema: AttributeSchema) -> AttributeSchema:
    """Register a schema after enforcing the 125*n*m byte budget."""
    if not schema.within_budget():
        raise ValueError(
            f"schema {schema.name!r} packs {schema.bytes_per_cell()} bytes per "
            f"cell, over the paper's {PAPER_BYTES_PER_CELL}-byte budget")
    _REGISTRY[schema.name] = schema
    return schema


def get_schema(name: str) -> AttributeSchema:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown attribute schema {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def list_schemas() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

#: The paper's five PAPI-era attributes.  Miss *rates* combine as
#: duration-weighted means (a multi-call region's rate is not the last call's
#: rate); I/O byte counts and instruction counts sum.  ``instr_attr`` mirrors
#: the ``instructions`` locate field so root-cause tables can consult it
#: without re-reading the locate block.  Provider keys follow the role map
#: in ``perfdbg.attributes`` (l1 -> vmem pressure proxy, l2 -> HBM
#: boundedness, disk -> host I/O, network -> collectives, instructions ->
#: HLO flops), so one cost provider serves both built-in schemas.
PAPER_SCHEMA = register_schema(AttributeSchema("paper", (
    AttributeField("l1_miss_rate", WMEAN,
                   provider_key="vmem_pressure", role=ROLE_MEMORY),
    AttributeField("l2_miss_rate", WMEAN,
                   provider_key="hbm_boundedness", role=ROLE_MEMORY),
    AttributeField("disk_io", SUM,
                   provider_key="host_io_bytes", role=ROLE_IO),
    AttributeField("network_io", SUM,
                   provider_key="collective_bytes", role=ROLE_NETWORK),
    AttributeField("instr_attr", SUM, source="instructions",
                   export="instructions",
                   provider_key="hlo_flops", role=ROLE_WORK),
)))

#: The TPU/roofline adaptation (see perfdbg.attributes for the derivation):
#: pressure/boundedness ratios are rates (weighted means); byte counters and
#: HLO flops sum.  ``hlo_flops`` mirrors ``instructions`` — with no provider
#: attached, workloads record analytic flop counts there.
TPU_SCHEMA = register_schema(AttributeSchema("tpu", (
    AttributeField("vmem_pressure", WMEAN,
                   provider_key="vmem_pressure", role=ROLE_MEMORY),
    AttributeField("hbm_boundedness", WMEAN,
                   provider_key="hbm_boundedness", role=ROLE_MEMORY),
    AttributeField("host_io_bytes", SUM,
                   provider_key="host_io_bytes", role=ROLE_IO),
    AttributeField("collective_bytes", SUM,
                   provider_key="collective_bytes", role=ROLE_NETWORK),
    AttributeField("hlo_flops", SUM, source="instructions",
                   provider_key="hlo_flops", role=ROLE_WORK),
)))
