"""Region instrumentation for step functions (the paper's 'automatic
instrumentation' layer, adapted: JAX programs are traced Python, so regions
are declared by the framework rather than injected by a source-to-source
compiler — granularity presets mirror the paper's instrumentation modes).

Wall time:  perf_counter around the region (includes waits).
CPU time:   process_time (excludes I/O / sleep — the paper's CPU-clock-time
            distinction, which is what lets clustering separate compute
            imbalance from waiting).
cycles:     CPU time x nominal frequency.
instructions: supplied by the workload (analytic op counts) — PAPI has no
            TPU/CPU-portable equivalent here; DESIGN.md §8 records this
            adaptation.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

from repro_torch.core import RegionTree
from .recorder import RegionRecorder

NOMINAL_HZ = 2.0e9

# granularity presets (paper: outer loop / functions / parallel lib / ...)
GRANULARITIES = ("step", "layer", "op")


def _process_time_works(probe_s: float = 0.02, need_ticks: int = 4) -> bool:
    """Sandboxed containers (gVisor-style) may pin or coarsely quantize
    CLOCK_PROCESS_CPUTIME_ID; process_time() then reads 0 (or one fat tick)
    over the few-millisecond intervals we calibrate with, collapsing every
    CPU-time record to zero.  Probe the *effective resolution* once: burn CPU
    for ``probe_s`` and require several distinct clock values in that span."""
    w0 = time.perf_counter()
    seen = {time.process_time()}
    while time.perf_counter() - w0 < probe_s:
        sum(range(200))
        seen.add(time.process_time())
    return len(seen) >= need_ticks


_cpu_clock = None


def CPU_CLOCK() -> float:
    """CPU clock used for all cpu_time records: process_time when the kernel
    supports it (excludes I/O waits — the paper's CPU-clock distinction),
    otherwise perf_counter as the best available proxy.  The probe runs
    lazily on first use so importing the package stays free."""
    global _cpu_clock
    if _cpu_clock is None:
        _cpu_clock = (time.process_time if _process_time_works()
                      else time.perf_counter)
    return _cpu_clock()


class Instrumenter:
    """Times named regions for one rank and feeds a RegionRecorder."""

    def __init__(self, recorder: RegionRecorder, rank: int):
        self.recorder = recorder
        self.rank = rank
        self._tree = recorder.tree
        self._names: Dict[str, int] = {
            self._tree.name(rid): rid for rid in self._tree.ids()}
        CPU_CLOCK()  # resolve the clock now, not inside the first region's wall

    def region_id(self, name: str) -> int:
        return self._names[name]

    @contextlib.contextmanager
    def region(self, name: str, *, instructions: float = 0.0,
               nominal_cpi: Optional[float] = None,
               **attrs: Optional[float]) -> Iterator[None]:
        """Time a region.  Keyword attributes are forwarded to the recorder
        and must belong to its schema (e.g. ``disk_io=...`` under the
        ``paper`` schema, ``collective_bytes=...`` under ``tpu``).  When
        the recorder has a cost provider attached (``perfdbg.costs``),
        fields the provider covers need no keywords at all — each region
        exit records one execution's provider costs automatically, and an
        explicit keyword still wins over the provider.

        ``instructions`` is the workload's analytic op count.  For host-side
        regions with no analytic count (data loading, checkpoint I/O), pass
        ``nominal_cpi`` instead: instructions are derived from measured
        cycles at that CPI, keeping the region's CRNM proportional to its
        time share rather than exploding on a token-count denominator."""
        rid = self._names[name]
        w0 = time.perf_counter()
        c0 = CPU_CLOCK()
        try:
            yield
        finally:
            wall = time.perf_counter() - w0
            cpu = CPU_CLOCK() - c0
            cycles = cpu * NOMINAL_HZ
            if nominal_cpi is not None and not instructions:
                instructions = cycles / nominal_cpi
            self.recorder.add(
                self.rank, rid, cpu_time=cpu, wall_time=wall,
                cycles=cycles, instructions=instructions, **attrs)

    @contextlib.contextmanager
    def program(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.recorder.add_program_wall(self.rank,
                                           time.perf_counter() - t0)


def build_step_tree(layer_names, granularity: str = "layer") -> RegionTree:
    """Region tree for an instrumented training step:
    program -> {data, embed, layers{...}, loss, optimizer, checkpoint}."""
    t = RegionTree("train_step")
    t.add("data")
    t.add("embed")
    layers = t.add("layers")
    if granularity in ("layer", "op"):
        for nm in layer_names:
            lid = t.add(nm, parent=layers)
            if granularity == "op":
                t.add(f"{nm}.mix", parent=lid)   # attn / rnn / moe
                t.add(f"{nm}.ffn", parent=lid)
    t.add("loss")
    t.add("optimizer")
    t.add("checkpoint")
    return t
