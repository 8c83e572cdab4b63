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


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t, sequential scan.  a, b: (B, S, W)."""
    B, S, W = a.shape
    h = a.new_zeros((B, W)) if h0 is None else h0
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None):
    """Sequential WKV6 over merged (BH, T, dh) tensors; u: (BH, dh).
    Returns (y (BH, T, dh) in r's dtype, s_final (BH, dh, dh) fp32).  v
    (and s0, y, s_final with it) may hold any dv <= dh of the value
    columns: column e of y and of the state depends on v[..., e] alone."""
    BH, T, dh = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    s = r.new_zeros((BH, dh, dv), dtype=f32) if s0 is None else s0.to(f32)
    uf = u.to(f32)[:, :, None]
    ys = []
    for t in range(T):
        r_t, k_t, v_t, lw_t = (a[:, t].to(f32) for a in (r, k, v, logw))
        kv = torch.einsum("bd,be->bde", k_t, v_t)
        ys.append(torch.einsum("bd,bde->be", r_t, s + uf * kv))
        s = torch.exp(lw_t)[..., None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s
