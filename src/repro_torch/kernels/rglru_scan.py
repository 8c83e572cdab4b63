"""Wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The kernel replaces ``repro/kernels/rglru_scan.py::_rglru_kernel``; its
note in the source gives its bound and design.  This wrapper checks
device, dtype, shape and contiguity and raises on anything else, allocates
h with ``torch.empty``, launches on the current stream without
synchronizing, and raises on the launch's ``cudaError_t``.
``rglru_scan_kernel.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import _check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int

# a, b, h0, h, B, S, W, stream
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P]
C_ENTRIES = {"rglru_scan_fwd_launch": ARGTYPES}


@functools.cache
def _kernel():
    """The C entry point ``rglru_scan_fwd_launch``, built and typed once."""
    fn = _build.load("rglru_scan").rglru_scan_fwd_launch
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def check_inputs(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    """Raise unless the kernel takes these tensors (device aside)."""
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


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t on the card.  a, b: (B, S, W) fp32; h0:
    (B, W) fp32 or None (zeros).  Returns h: (B, S, W) fp32."""
    _check_cuda(a=a, b=b, h0=h0)
    check_inputs(a, b, h0)
    B, S, W = a.shape
    with torch.cuda.device(a.device):
        h = torch.empty_like(a)
        err = _kernel()(a.data_ptr(), b.data_ptr(),
                        None if h0 is None else h0.data_ptr(), h.data_ptr(),
                        B, S, W, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_fwd_launch failed: cudaError_t {err}")
    rglru_scan_kernel.launches += 1
    return h


rglru_scan_kernel.launches = 0
