"""Wrapper of the Hopper WKV6 kernel (``csrc/wkv6.cu``).

The kernel replaces ``repro/kernels/wkv6.py::_wkv6_kernel``; its note in
the source gives its bound and design.  This wrapper takes the model's
layout directly — r, k, v, logw ``(B, T, H, dh)``, u ``(H, dh)`` — and
passes strides, so heads are never merged by a copy.  It checks device,
dtype, shape, contiguity and the 16-byte alignment the kernel's
``cp.async`` copies need, and raises on anything else, allocates y and the
final state with ``torch.empty``, launches on the current stream without
synchronizing, and raises on the launch's ``cudaError_t``.
``wkv6_kernel.launches`` counts the launches.  The kernel gives each CTA
``VALUE_COLUMNS_PER_CTA`` value columns of one (b, h) (:func:`grid`);
:func:`schedule` reads the compiled schedule back from the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import _check_cuda

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (32, 64)
MAX_GRID_X = 2 ** 31 - 1
VALUE_COLUMNS_PER_CTA = 16   # EV in csrc/wkv6.cu
ALIGN = 16                   # bytes, for cp.async

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# r, k, v, logw, u, s0, y, s_out, is_bf16, B, T, H, dh, 15 strides, stream
ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 15 + [_P]
# is_bf16, dh, out (int[4])
INFO_ARGTYPES = [_I, _I, _P]
C_ENTRIES = {"wkv6_fwd_launch": ARGTYPES, "wkv6_fwd_info": INFO_ARGTYPES}


@functools.cache
def _kernel():
    """The C entry point ``wkv6_fwd_launch``, built and typed once."""
    fn = _build.load("wkv6").wkv6_fwd_launch
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def grid(B: int, H: int, dh: int) -> int:
    """CTAs of one launch: one per (b, h) and block of value columns."""
    return B * H * (dh // VALUE_COLUMNS_PER_CTA)


def schedule(dtype: torch.dtype, dh: int) -> dict:
    """The compiled kernel's schedule for ``dtype`` and ``dh``, read from the
    card: value columns and threads per CTA, static shared memory per CTA
    and CTAs resident per SM."""
    fn = _build.load("wkv6").wkv6_fwd_info
    fn.argtypes = INFO_ARGTYPES
    fn.restype = _I
    out = (ctypes.c_int * 4)()
    err = fn(int(dtype == torch.bfloat16), dh, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"wkv6_fwd_info failed: cudaError_t {err}")
    return dict(value_columns=out[0], threads=out[1], smem_bytes=out[2],
                ctas_per_sm=out[3])


def check_inputs(r, k, v, logw, u, s0) -> None:
    """Raise unless the kernel takes these tensors (device aside)."""
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if t is None:
            continue
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; supported: {SUPPORTED_DTYPES}")
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError(f"r/k/v dtypes differ: {r.dtype}, {k.dtype}, {v.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D (B, T, H, dh), got {tuple(r.shape)}")
    if not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"shape mismatch: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logw {tuple(logw.shape)}")
    for name, t in (("logw", logw), ("u", u), ("s0", s0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes float32")
    B, T, H, dh = r.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if tuple(u.shape) != (H, dh):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {(H, dh)}")
    if s0 is not None and tuple(s0.shape) != (B, H, dh, dh):
        raise ValueError(f"s0 has shape {tuple(s0.shape)}, expected {(B, H, dh, dh)}")
    if min(B, T, H) == 0 or grid(B, H, dh) > MAX_GRID_X:
        raise ValueError(f"unsupported sizes B={B}, T={T}, H={H}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("s0", s0)):
        if t is not None and t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must start on a {ALIGN}-byte boundary")


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 on the card.  r, k, v: (B, T, H, dh), one dtype; logw: (B, T,
    H, dh) fp32; u: (H, dh) fp32; s0: (B, H, dh, dh) fp32 or None (zeros).
    Returns (y in r's dtype, s_final (B, H, dh, dh) fp32)."""
    _check_cuda(r=r, k=k, v=v, logw=logw, u=u, s0=s0)
    check_inputs(r, k, v, logw, u, s0)
    B, T, H, dh = r.shape
    with torch.cuda.device(r.device):
        y = torch.empty_like(r)
        s_final = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
        err = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_final.data_ptr(),
            int(r.dtype == torch.bfloat16), B, T, H, dh,
            *(s for t in (r, k, v, logw, y) for s in (t.stride(0), t.stride(1), t.stride(2))),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_fwd_launch failed: cudaError_t {err}")
    wkv6_kernel.launches += 1
    return y, s_final


wkv6_kernel.launches = 0
