"""Peak rates of the card, and the least time a piece of work can take.

A frozen copy of ``chip_smoke.py``'s ``PEAKS``, ``peaks`` and ``bound``,
kept here so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

# Dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, fp32 (no tensor
# cores) FLOP/s, HBM bytes/s.
PEAKS = {"H100 PCIe": (756e12, 51.2e12, 2.0e12), "H100 NVL": (835e12, 60e12, 3.9e12),
         "H100": (989e12, 67e12, 3.35e12)}


def peaks(name: str):
    for key, val in PEAKS.items():     # most specific first
        if key in name:
            return key, val
    raise RuntimeError(f"no peak rates known for {name!r}")


def bound(flops: float, nbytes: float, flops_peak: float, bw_peak: float):
    """(least time in ms, what bounds it) for this work on the card."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
