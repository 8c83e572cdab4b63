"""Public entry points of the port's kernels.

Each op launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor; any other device raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .ref import flash_attention_ref


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`attention`: GQA expanded by repeat, heads
    merged into the batch, :func:`flash_attention_ref`."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H != K:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    qm = q.transpose(1, 2).reshape(B * H, Sq, dh)
    km = k.transpose(1, 2).reshape(B * H, Sk, dh)
    vm = v.transpose(1, 2).reshape(B * H, Sk, dh)
    o = flash_attention_ref(qm, km, vm, causal=causal, window=window,
                            softcap=softcap, scale=scale)
    return o.reshape(B, H, Sq, dh).transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """GQA flash attention.  q: (B, Sq, H, dh); k, v: (B, Sk, K, dh)."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no attention kernel for device {q.device}")
