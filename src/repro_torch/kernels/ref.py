"""Plain PyTorch versions of the port's kernels (the oracles).

Each function computes what its kernel computes, in the simplest form:
the CPU path of the wrappers and the comparison ``chip_smoke.py`` holds the
kernels against on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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


def ssm_state_update_ref(state: torch.Tensor, conv_state: torch.Tensor, z: torch.Tensor,
                         xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
                         conv_b: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                         D: torch.Tensor, norm_scale: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """One Mamba-2 layer's decode step between its projections, both states
    in place.  state (batch, H, P, N) fp32; conv_state (batch, conv_dim,
    taps - 1), the conv's last inputs; z (batch, H P), xbc (batch,
    conv_dim = H P + 2 G N), dt (batch, H): the in-projection's output
    for this token; conv_w (conv_dim, taps), conv_b (conv_dim,); dt_bias,
    A_log, D (H,); norm_scale (H P,).  Per head h of group g = h // (H / G):
        [x, B, C] = SiLU(conv_b + sum_j conv_w[:, j] ext_j), ext the conv
                    state's inputs then xbc (the conv state rolled by one)
        dt = softplus(dt + dt_bias);  A = -exp(A_log)
        S <- exp(dt A) S + dt x (outer) B_g;  y = S C_g + D x
    and returns RMSNorm over G groups of y * SiLU(z), times (1 + scale),
    in z's dtype; fp32 math."""
    H, P, N = state.shape[1:]
    G = (xbc.shape[-1] - H * P) // (2 * N)
    ext = torch.cat([conv_state, xbc[..., None].to(conv_state.dtype)], dim=-1)
    conv_state.copy_(ext[..., 1:])
    xf, w = ext.float(), conv_w.float()
    u = xf[..., 0] * w[:, 0]
    for j in range(1, w.shape[1]):
        u = u + xf[..., j] * w[:, j]
    u = F.silu(u + conv_b.float())
    x, B, C = u.split([H * P, G * N, G * N], dim=-1)
    x = x.reshape(-1, H, P)
    Bh = B.reshape(-1, G, N).repeat_interleave(H // G, dim=1)          # (batch, H, N)
    Ch = C.reshape(-1, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt.float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    state.mul_(torch.exp(dt * A)[..., None, None])
    state.add_((dt[..., None] * x)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + D.float()[:, None] * x
    return gated_rms_norm_ref(y.reshape(-1, H * P), z, norm_scale, G, eps)


def gated_rms_norm_ref(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                       groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gated norm, the gate before the norm: RMSNorm over
    ``groups`` groups of the last dimension of y * SiLU(z), times
    (1 + scale); fp32 math, the result in z's dtype."""
    h = y * F.silu(z.float())
    hg = h.view(*h.shape[:-1], groups, -1)
    hg = hg * torch.rsqrt(torch.mean(hg * hg, dim=-1, keepdim=True) + eps)
    return (hg.view(h.shape) * (1.0 + scale.float())).to(z.dtype)
