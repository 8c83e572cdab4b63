"""Cost providers: per-region attribute values from a declared cost model
(perfdbg layer: pure data + arithmetic; imports neither jax nor launch).

The paper's root-cause step is only as good as the attribute vectors it
feeds the rough-set tables — and before this layer existed, the ``tpu``
schema's cost attributes were hand-written analytic estimates inlined in
the training driver.  A :class:`CostProvider` makes the source of those
numbers a pluggable, testable object:

    provider.region_costs(region_name) -> {provider key: value}

The contract is **per execution**: the returned values describe ONE
execution of the region (one step, one decode round, ...).  A windowed
``RegionRecorder`` with a provider attached pulls them on every ``add``,
so SUM fields accumulate execution counts naturally and WMEAN ratio
fields stay constant.  Which schema field a key lands in is declared by
the schema itself (``AttributeField.provider_key``) — a provider may
report more terms than a given schema records.

Canonical provider keys (:data:`PROVIDER_KEYS`):

    hlo_flops          flops of one region execution
    hbm_bytes          HBM traffic of one execution (not itself a schema
                       field; the boundedness ratios derive from it)
    collective_bytes   inter-chip collective traffic
    host_io_bytes      host <-> device / disk bytes
    hbm_boundedness    1 - intensity/ridge, clipped to [0, 1]
    vmem_pressure      on-chip pressure proxy (0.5 x boundedness)

Two implementations ship here:

* :class:`AnalyticCosts` — closed-form estimates (the formulas formerly
  inlined in ``launch/train.py``, extracted and owned here).
* :class:`HloCosts` — measured from the compiled step's HLO, built from a
  per-computation stats map (``launch.hlo_analysis.Analyzer.
  stats_by_computation()``), with explicit per-region coverage/residual
  accounting for ops it cannot attribute.  The class consumes plain
  stats objects/dicts so this module never imports the launch layer;
  ``launch.steps.hlo_cost_provider`` is the one-call glue.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

from .attributes import RIDGE_INTENSITY

#: The canonical vocabulary of ``region_costs`` keys.  Providers may emit a
#: subset; schemas map them onto fields via ``AttributeField.provider_key``.
PROVIDER_KEYS = ("hlo_flops", "hbm_bytes", "collective_bytes",
                 "host_io_bytes", "hbm_boundedness", "vmem_pressure")


def boundedness_ratios(flops: float, hbm_bytes: float) -> Dict[str, float]:
    """Roofline ratios from one execution's flops and HBM bytes:
    ``hbm_boundedness`` is how far below the compute ridge the region sits
    (1 = fully HBM-bound), ``vmem_pressure`` its on-chip proxy (half the
    boundedness, mirroring ``attributes.region_attributes``)."""
    intensity = max(float(flops), 1.0) / max(float(hbm_bytes), 1.0)
    hbm_b = min(max(1.0 - intensity / RIDGE_INTENSITY, 0.0), 1.0)
    return {"hbm_boundedness": hbm_b, "vmem_pressure": 0.5 * hbm_b}


class CostProvider:
    """Protocol for per-region cost sources (mirrors ``core.policy.Policy``:
    subclass and implement).  ``region_costs`` must be cheap and pure — the
    recorder may call it on the step loop's critical path (it memoizes per
    region, but the first call per region is inline)."""

    def region_costs(self, region: str) -> Mapping[str, float]:
        """Costs of ONE execution of ``region``, keyed by provider key
        (see :data:`PROVIDER_KEYS`).  Unknown regions return ``{}``."""
        raise NotImplementedError


class AnalyticCosts(CostProvider):
    """Closed-form per-region cost estimates.

    Holds a plain ``{region: {key: value}}`` table; the transformer-step
    classmethod below owns the estimates that used to live inline in
    ``launch/train.py`` (roughly: 6*N*T flops, params touched twice for
    fwd+bwd reads plus activation traffic)."""

    def __init__(self, costs: Mapping[str, Mapping[str, float]]):
        self._costs = {r: {k: float(v) for k, v in c.items()}
                       for r, c in costs.items()}

    def region_costs(self, region: str) -> Dict[str, float]:
        return dict(self._costs.get(region, {}))

    @property
    def regions(self) -> Tuple[str, ...]:
        return tuple(self._costs)

    @classmethod
    def for_train_step(cls, *, active_params: float, total_params: float,
                       d_model: int, n_layers: int, tokens_per_step: int,
                       checkpoint_io_bytes: float = 0.0) -> "AnalyticCosts":
        """Estimates for the instrumented train loop's three regions.

        ``step``: MODEL_FLOPS = 6*N*T over active params; HBM traffic as
        params touched twice (fwd+bwd reads) plus activations — only the
        ratio to flops matters for the boundedness flags.  ``data``: 8
        bytes per token crossing the host boundary.  ``checkpoint``:
        whatever the driver expects one save to write (0 disables)."""
        flops = 6.0 * float(active_params) * tokens_per_step
        hbm = (2.0 * float(total_params) * 2
               + 8.0 * tokens_per_step * d_model * n_layers)
        return cls({
            "data": {"host_io_bytes": 8.0 * tokens_per_step},
            "step": {"hlo_flops": flops, "hbm_bytes": hbm,
                     "collective_bytes": 0.0,
                     **boundedness_ratios(flops, hbm)},
            "checkpoint": {"host_io_bytes": float(checkpoint_io_bytes)},
        })


# ---------------------------------------------------------------------------
# HLO-measured costs
# ---------------------------------------------------------------------------

def _stat_terms(stats) -> Tuple[float, float, float]:
    """(flops, hbm bytes, collective bytes) from a ``hlo_analysis.Stats``
    object or its ``as_dict()`` form — duck-typed so this module never
    imports the launch layer."""
    if isinstance(stats, Mapping):
        return (float(stats["flops"]), float(stats["bytes"]),
                float(stats["total_collective_bytes"]))
    return (float(stats.flops), float(stats.bytes),
            float(stats.total_collective_bytes))


def _sanitize(name: str) -> str:
    """Region name -> the identifier HLO computation names can carry
    (anything outside [A-Za-z0-9_.-] becomes '_', matching XLA's own
    sanitization of computation names)."""
    return re.sub(r"[^\w.\-]", "_", name)


@dataclasses.dataclass(frozen=True)
class ModuleCoverage:
    """Attribution accounting for one compiled module anchored at a region.

    ``total_flops`` is the module's trip-aware entry cost;
    ``attributed_flops`` is the share re-attributed to *other* regions by
    computation-name prefix matching; ``residual_flops`` is what stayed on
    the anchor because no region name claimed it.  ``matched`` maps each
    re-attributed computation to its region; ``unmatched`` counts the
    module's remaining computations (they are not lost — their cost is the
    residual, by construction)."""

    anchor: str
    total_flops: float
    attributed_flops: float
    residual_flops: float
    matched: Tuple[Tuple[str, str], ...]   # (computation, region) pairs
    unmatched: int

    @property
    def coverage(self) -> float:
        """Fraction of the module's flops attributed to named regions
        beyond the anchor (0.0 = everything rode the residual)."""
        return self.attributed_flops / self.total_flops \
            if self.total_flops > 0 else 0.0

    def render(self) -> str:
        return (f"{self.anchor}: flops={self.total_flops:.3e} "
                f"matched={len(self.matched)} comps "
                f"({100 * self.coverage:.1f}%) "
                f"residual={self.residual_flops:.3e} "
                f"unmatched={self.unmatched}")


class HloCosts(CostProvider):
    """Measured per-region costs from compiled (post-SPMD, per-device) HLO.

    Each :meth:`add_module` call anchors one compiled module at a region —
    the region whose Python-level body launches the module (``step`` for a
    jitted train step, ``prefill``/``decode`` for serving).  The module's
    trip-aware entry stats become the anchor's measured costs; within the
    module, computations whose name starts with another known region's
    sanitized name are re-attributed to that region (longest prefix wins),
    and whatever the prefix match cannot claim stays on the anchor as the
    *residual*.  :meth:`coverage` reports the accounting per anchor, so a
    consumer can see exactly how much of each module was explicitly
    attributed versus carried residually.

    ``base`` is an optional fallback provider consulted first and
    overlaid by measured keys — the usual composition is analytic host-side
    estimates (data loading, checkpoint writes) under HLO-measured device
    costs, since host I/O never appears in a compiled module.
    """

    def __init__(self, regions: Sequence[str],
                 base: Optional[CostProvider] = None):
        self._regions = tuple(regions)
        self._base = base
        self._costs: Dict[str, Dict[str, float]] = {}
        self._coverage: Dict[str, ModuleCoverage] = {}

    def add_module(self, comp_stats: Mapping[str, object], entry: str,
                   anchor: str) -> "HloCosts":
        """Attribute one compiled module.  ``comp_stats`` is the analyzer's
        per-computation stats map (``stats_by_computation()``), ``entry``
        its entry computation name, ``anchor`` the region that launches the
        module.  Returns self for chaining.

        Matched computations are assumed disjoint (one region's computation
        does not call another's); nested matches would double-subtract, so
        the residual is floored at zero and the coverage record keeps the
        raw attributed sum for inspection."""
        if anchor not in self._regions:
            raise KeyError(f"anchor {anchor!r} is not a known region "
                           f"(have {list(self._regions)})")
        if entry not in comp_stats:
            raise KeyError(f"entry computation {entry!r} missing from the "
                           f"stats map")
        total_f, total_b, total_c = _stat_terms(comp_stats[entry])
        # longest sanitized region name wins when names nest
        # ("layers.layer_0" before "layers")
        prefixes = sorted(((_sanitize(r), r) for r in self._regions
                           if r != anchor),
                          key=lambda p: -len(p[0]))
        matched: list = []
        attributed = {r: [0.0, 0.0, 0.0] for r in self._regions}
        unmatched = 0
        for cname, stats in comp_stats.items():
            if cname == entry:
                continue
            region = next((r for s, r in prefixes
                           if cname == s or cname.startswith(s + ".")
                           or cname.startswith(s + "_")), None)
            if region is None:
                unmatched += 1
                continue
            f, b, c = _stat_terms(stats)
            acc = attributed[region]
            acc[0] += f
            acc[1] += b
            acc[2] += c
            matched.append((cname, region))
        attr_f = sum(v[0] for v in attributed.values())
        residual = (max(total_f - attr_f, 0.0),
                    max(total_b - sum(v[1] for v in attributed.values()), 0.0),
                    max(total_c - sum(v[2] for v in attributed.values()), 0.0))
        for region, (f, b, c) in attributed.items():
            if f or b or c:
                self._set_costs(region, f, b, c)
        self._set_costs(anchor, *residual)
        self._coverage[anchor] = ModuleCoverage(
            anchor, total_f, min(attr_f, total_f), residual[0],
            tuple(sorted(matched)), unmatched)
        return self

    def _set_costs(self, region: str, flops: float, hbm: float,
                   coll: float) -> None:
        cur = self._costs.setdefault(
            region, {"hlo_flops": 0.0, "hbm_bytes": 0.0,
                     "collective_bytes": 0.0})
        cur["hlo_flops"] += flops
        cur["hbm_bytes"] += hbm
        cur["collective_bytes"] += coll
        if cur["hlo_flops"] > 0 or cur["hbm_bytes"] > 0:
            cur.update(boundedness_ratios(cur["hlo_flops"], cur["hbm_bytes"]))

    # -- CostProvider --------------------------------------------------------
    def region_costs(self, region: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self._base is not None:
            out.update(self._base.region_costs(region))
        out.update(self._costs.get(region, {}))
        return out

    # -- accounting ------------------------------------------------------------
    def coverage(self) -> Dict[str, ModuleCoverage]:
        """anchor region -> attribution accounting of its module."""
        return dict(self._coverage)

    def residual(self, anchor: str) -> float:
        """Flops of ``anchor``'s module left unattributed (on the anchor)."""
        return self._coverage[anchor].residual_flops

    def render_coverage(self) -> str:
        if not self._coverage:
            return "(no modules attributed)"
        return "\n".join(c.render()
                         for _, c in sorted(self._coverage.items()))
