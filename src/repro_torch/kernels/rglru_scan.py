"""Wrapper of the Hopper RG-LRU scan kernels, K2 (``csrc/rglru_scan.cu``).

Both kernels replace ``repro/kernels/rglru_scan.py::_rglru_kernel`` and
equal the plain loop bit for bit; the note in the source gives their bound
and design.  :func:`variant` chooses one by shape alone:

- ``"staged"`` (``rglru_scan_staged_launch``): every S > 1 with W % 4 == 0,
  the prefill's shapes — CTAs of 64 channels, a and b staged by TMA through
  a ring of shared memory;
- ``"simple"`` (``rglru_scan_fwd_launch``): S == 1 (the decode step) and
  any W % 4 != 0 — one thread per channel.

This wrapper checks device, dtype, shape, contiguity and, for the staged
kernel, the 16-byte alignment its tensor maps need, and raises on anything
else, allocates h with ``torch.empty``, launches the chosen kernel on the
current stream without synchronizing, and raises on the launch's
``cudaError_t``; a failed launch is never retried with the other kernel.
``rglru_scan_kernel.launches`` counts the launches,
``rglru_scan_kernel.launches_by_variant`` the launches of each kernel.
:func:`schedule` reads the staged kernel's compiled schedule back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import _check_cuda

CHANNELS_PER_CTA = 64   # TW in csrc/rglru_scan.cu
ALIGN = 16              # bytes, for the staged kernel's tensor maps

_P = ctypes.c_void_p
_I = ctypes.c_int

# a, b, h0, h, B, S, W, stream
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P]
# out (int[6])
INFO_ARGTYPES = [_P]
# variant -> its C entry point in csrc/rglru_scan.cu
ENTRIES = {"staged": "rglru_scan_staged_launch", "simple": "rglru_scan_fwd_launch"}
C_ENTRIES = {**{entry: ARGTYPES for entry in ENTRIES.values()},
             "rglru_scan_staged_info": INFO_ARGTYPES}


def variant(B: int, S: int, W: int) -> str:
    """The kernel that takes a (B, S, W) scan: ``"staged"`` for S > 1 with
    W % 4 == 0, ``"simple"`` otherwise (B does not enter)."""
    return "staged" if S > 1 and W % 4 == 0 else "simple"


def grid(B: int, W: int) -> int:
    """CTAs of one staged launch: one per batch row and tile of channels."""
    return B * -(-W // CHANNELS_PER_CTA)


@functools.cache
def _kernel(name: str):
    """The C entry point of variant ``name``, built and typed once."""
    fn = getattr(_build.load("rglru_scan"), ENTRIES[name])
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def schedule() -> dict:
    """The staged kernel's compiled schedule, read from the card: channels
    and threads per CTA, stages of the ring and steps per stage, dynamic
    shared memory per CTA and CTAs resident per SM."""
    fn = _build.load("rglru_scan").rglru_scan_staged_info
    fn.argtypes = INFO_ARGTYPES
    fn.restype = _I
    out = (ctypes.c_int * 6)()
    err = fn(ctypes.addressof(out))
    if err:
        raise RuntimeError(f"rglru_scan_staged_info failed: cudaError_t {err}")
    return dict(channels=out[0], threads=out[1], stages=out[2], steps_per_stage=out[3],
                smem_bytes=out[4], ctas_per_sm=out[5])


def check_inputs(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    """Raise unless the kernel :func:`variant` chooses takes these tensors
    (device aside)."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be (B, S, W) of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, S, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {(B, W)}")
    if min(B, S, W) == 0 or max(B, S, W) > 2 ** 31 - 1:
        raise ValueError(f"unsupported sizes B={B}, S={S}, W={W}")
    if variant(B, S, W) == "staged":
        for name, t in (("a", a), ("b", b)):
            if t.data_ptr() % ALIGN:
                raise ValueError(f"{name} must start on a {ALIGN}-byte boundary")


def launch(kind: str, a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch kernel ``kind`` ("staged" or "simple") on checked CUDA tensors,
    uncounted.  :func:`rglru_scan_kernel` is the entry point; this lets
    ``chip_smoke.py`` time each kernel at the shapes :func:`variant` gives
    the other."""
    B, S, W = a.shape
    with torch.cuda.device(a.device):
        h = torch.empty_like(a)
        err = _kernel(kind)(a.data_ptr(), b.data_ptr(),
                            None if h0 is None else h0.data_ptr(), h.data_ptr(),
                            B, S, W, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{ENTRIES[kind]} failed: cudaError_t {err}")
    return h


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t on the card.  a, b: (B, S, W) fp32; h0:
    (B, W) fp32 or None (zeros).  Returns h: (B, S, W) fp32."""
    _check_cuda(a=a, b=b, h0=h0)
    check_inputs(a, b, h0)
    kind = variant(*a.shape)
    h = launch(kind, a, b, h0)
    rglru_scan_kernel.launches += 1
    rglru_scan_kernel.launches_by_variant[kind] += 1
    return h


rglru_scan_kernel.launches = 0
rglru_scan_kernel.launches_by_variant = {name: 0 for name in ENTRIES}
