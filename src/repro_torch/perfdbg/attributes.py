"""Device-mode attribute derivation for the H100 (counterpart of
``repro/perfdbg/attributes.py``, rewritten: its constants are a TPU v5e's).

The paper's PAPI attributes (L1/L2 miss rate, disk I/O, network I/O,
instruction count) map by *role* to cost-model quantities of a step:

    l1_miss_rate  -> on-chip memory pressure proxy from arithmetic intensity
    l2_miss_rate  -> HBM boundedness:      bytes/flop relative to ridge point
    disk_io       -> host I/O bytes (data pipeline + checkpoint writes)
    network_io    -> collective bytes
    instructions  -> flops

The functions are the reference's; only the roofline constants differ.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# NVIDIA H100 SXM5 roofline constants (per card)
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s (NVIDIA H100 data sheet, SXM5)
HBM_BW = 3.35e12          # bytes/s, HBM3 (NVIDIA H100 data sheet, SXM5)
LINK_BW = 450e9           # bytes/s per direction, NVLink 4: 900 GB/s total
                          # bidirectional (NVIDIA H100 data sheet, SXM5)
RIDGE_INTENSITY = PEAK_FLOPS / HBM_BW   # ~295 flops/byte


def region_attributes(flops: np.ndarray, bytes_hbm: np.ndarray,
                      collective_bytes: np.ndarray,
                      host_io_bytes: np.ndarray) -> Dict[str, np.ndarray]:
    """Build the paper's five attribute matrices from per-region cost terms.
    All inputs are (m_shards, n_regions)."""
    flops = np.maximum(np.asarray(flops, dtype=np.float64), 1.0)
    bytes_hbm = np.asarray(bytes_hbm, dtype=np.float64)
    intensity = flops / np.maximum(bytes_hbm, 1.0)
    return {
        "l1_miss_rate": np.clip(1.0 - intensity / RIDGE_INTENSITY, 0.0, 1.0) * 0.5,
        "l2_miss_rate": np.clip(1.0 - intensity / RIDGE_INTENSITY, 0.0, 1.0),
        "disk_io": np.asarray(host_io_bytes, dtype=np.float64),
        "network_io": np.asarray(collective_bytes, dtype=np.float64),
        "instructions": flops,
    }


def roofline_terms(flops: float, bytes_hbm: float, collective_bytes: float
                   ) -> Dict[str, float]:
    """Per-device three-term roofline (seconds)."""
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": collective_bytes / LINK_BW,
    }


def dominant_term(terms: Mapping[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k]).replace("_s", "")
