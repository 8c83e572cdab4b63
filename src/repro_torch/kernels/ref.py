"""Plain PyTorch versions of the port's kernels (the oracles).

Each function computes what its kernel computes, in the simplest form:
the CPU path of the wrappers and the comparison ``chip_smoke.py`` holds the
kernels against on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S^2) attention.  q/k/v: (BH, S, dh)."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    s = torch.einsum("bqd,bsd->bqs", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsd->bqd", p, v.float()).to(q.dtype)
