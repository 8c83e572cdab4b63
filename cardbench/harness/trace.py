"""The traced run: the device's kernels over the measured window.

``torch.profiler`` traces CUDA activity only: CPU activity would record
every aten operation of thousands of decode steps.  The kernels' start
times are on the profiler's clock (Unix nanoseconds); one pairing of that
clock with ``time.perf_counter_ns`` puts them on the host clock the
benchmark's spans and window use.  The kernel categories are a frozen copy
of ``tools/profile_serving.py``'s.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

K1 = "K1 flash attention"
CATEGORIES = (("flash_fwd", K1), ("rglru", "K2 rglru_scan"), ("wkv6", "K3 wkv6"))
MATMUL_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
TOP = 10

Kernel = Tuple[str, float, float]       # name, start s, end s (host perf_counter)


def category(kernel: str) -> str:
    name = kernel.lower()
    for mark, label in CATEGORIES:
        if mark in name:
            return label
    if any(mark in name for mark in MATMUL_MARKS):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.offset_ns = 0

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.__enter__()
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def kernels(self) -> List[Kernel]:
        from torch.autograd import DeviceType
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            t0 = (ev.start_ns() - self.offset_ns) * 1e-9
            out.append((ev.name(), t0, t0 + ev.duration_ns() * 1e-9))
        out.sort(key=lambda k: k[1])
        return out


def clip(kernels: Sequence[Kernel], t0: float, t1: float) -> List[Kernel]:
    """The kernels' parts inside [t0, t1]."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in kernels if b > t0 and a < t1]


def busy_and_gaps(kernels: Sequence[Kernel], t0: float, t1: float):
    """(seconds some kernel ran, idle intervals) within [t0, t1]; kernels
    sorted by start, clipped to the window."""
    busy, gaps, at = 0.0, [], t0
    for _, a, b in kernels:
        if a > at:
            gaps.append((at, a))
        if b > at:
            busy += b - max(a, at)
            at = b
    if at < t1:
        gaps.append((at, t1))
    return busy, gaps


def idle_by_span(gaps: Sequence[Tuple[float, float]], spans: Sequence[tuple]) -> Dict[str, float]:
    """Idle seconds by the host span that covers them ("other" where none
    does); spans are (name, t0 ns, t1 ns) on the host clock, in order."""
    out: Dict[str, float] = defaultdict(float)
    i = 0
    ordered = sorted(spans, key=lambda s: s[1])
    for a, b in gaps:
        at = a
        while i < len(ordered) and ordered[i][2] * 1e-9 <= at:
            i += 1
        j = i
        while at < b:
            if j < len(ordered) and ordered[j][1] * 1e-9 <= at:
                end = min(b, ordered[j][2] * 1e-9)
                out[ordered[j][0]] += end - at
                at = end
                j += 1
            else:
                nxt = ordered[j][1] * 1e-9 if j < len(ordered) else b
                end = min(b, nxt)
                out["other"] += end - at
                at = end
    return dict(out)


def top(totals: Dict[str, float], n: int = TOP) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def device_ops(kernels: Sequence[Kernel]) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for n, a, b in kernels:
        out[n] += b - a
    return dict(out)
