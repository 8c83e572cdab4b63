"""Wrapper of the Hopper flash-attention kernels, K1.

Both kernels replace ``repro/kernels/flash_attention.py::_flash_kernel``;
the notes in their sources give their bounds and designs.  :func:`variant`
chooses one by dtype and head size alone:

- ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): bf16 at d_head 64, 128
  and 256, the serving path's shapes (whisper's 64; the decoder LMs' 128
  and 256) — QK^T and PV on the tensor cores, K/V tiles loaded by TMA;
- ``"simt"`` (``csrc/flash_attention.cu``): fp32, and bf16 at d_head 16 and
  32, on the fp32 pipes.

This wrapper takes the model's layout directly — q ``(B, Sq, H, dh)``, k/v
``(B, Sk, K, dh)`` with ``H % K == 0`` — and passes strides, so GQA heads
are never copied.  It checks device, dtype, shape and contiguity and raises
on anything else, allocates the output with ``torch.empty``, launches the
chosen kernel on the current stream without synchronizing, and raises on
the launch's ``cudaError_t``; a failed launch is never retried with the
other kernel.  ``flash_attention.launches`` counts the launches,
``flash_attention.launches_by_variant`` the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
MAX_GRID_Y = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# both entry points: q, k, v, o, is_bf16, B, H, KH, Sq, Sk, dh, 12 strides,
# scale, causal, window, softcap, stream
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
            _F, _I, _I, _F, _P]
# variant -> (source under csrc/, its C entry point)
ENTRIES = {"simt": ("flash_attention", "flash_attention_fwd"),
           "wgmma": ("flash_attention_sm90", "flash_attention_sm90_fwd")}
C_ENTRIES = {entry: ARGTYPES for _, entry in ENTRIES.values()}


def variant(dtype: torch.dtype, dh: int) -> str:
    """The kernel that takes q/k/v of this dtype and head size: ``"wgmma"``
    for bf16 at d_head 64, 128 or 256, ``"simt"`` otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS else "simt"


@functools.cache
def _kernel(name: str):
    """The C entry point of variant ``name``, built and typed once."""
    source, entry = ENTRIES[name]
    fn = getattr(_build.load(source), entry)
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def _check_cuda(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes these tensors (device aside)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in SUPPORTED_DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; supported: {SUPPORTED_DTYPES}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, heads, dh), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v are on different devices")
    B, Sq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {K}")
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if min(B, Sq, k.shape[1]) == 0 or B * H > MAX_GRID_Y:
        raise ValueError(f"unsupported sizes B={B}, Sq={Sq}, Sk={k.shape[1]}, H={H}")


def launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, softcap: float = 0.0,
           scale: Optional[float] = None) -> torch.Tensor:
    """Launch kernel ``kind`` ("wgmma" or "simt") on checked CUDA tensors,
    uncounted.  :func:`flash_attention` is the entry point; this lets
    ``chip_smoke.py`` time the SIMT kernel at the shapes :func:`variant`
    gives to wgmma."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        err = _kernel(kind)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, K, Sq, Sk, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale), int(causal), int(window), float(softcap),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{ENTRIES[kind][1]} launch failed: cudaError_t {err}")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card.  q: (B, Sq, H, dh); k, v: (B, Sk, K, dh).
    Returns (B, Sq, H, dh) in q's dtype."""
    _check_cuda(q=q, k=k, v=v)
    check_inputs(q, k, v)
    kind = variant(q.dtype, q.shape[3])
    o = launch(kind, q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[kind] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_variant = {name: 0 for name in ENTRIES}
