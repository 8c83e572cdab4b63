"""RWKV-6 "Finch" block (Peng et al., arXiv:2404.05892), PyTorch.

Counterpart of ``repro/models/rwkv6.py``.  Time-mix with data-dependent
decay, per head h and channel c:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora_w(x~_t))), token-shift data-dependent lerps
for r/k/v/w/g, a per-head groupnorm on y, and a squared-ReLU channel-mix
FFN.

``apply_time_mix`` runs the recurrence through ``kernels.ops.wkv6`` (the
Hopper kernel K3 on the card, its plain sequential version on the CPU) for
prefill and for decode, where the reference's prefill takes the chunked
matmul form.  ``wkv6_sequential`` and ``wkv6_chunked`` are the reference's
two plain forms, kept for the comparisons.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..runtime import constrain, on_shards, placements
from ..runtime import pad as pad_zeros
from .layers import (Linear, _scalar, apply_linear, merge_heads, param,
                     raw_params, silu, split_heads)

LORA_DIM = 32
MIXES = ("r", "k", "v", "w", "g")

WkvFn = Callable[..., tuple]


def rwkv6_head_dim(cfg) -> int:
    return 64 if cfg.d_model % 64 == 0 else cfg.d_model // cfg.n_heads


class TimeMix(nn.Module):
    """Every key of the reference's ``rwkv6_spec`` under its name (the
    channel mix's weights included, as there)."""

    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d = cfg.d_model
        dh = rwkv6_head_dim(cfg)
        H = d // dh
        sc = 1.0 / math.sqrt(d)
        raw_params(self, {
            "mu": ((len(MIXES), d), (None, "embed"), "normal", 0.5),
            "mix_lora_a": ((d, len(MIXES) * LORA_DIM), ("embed", None), "normal", sc),
            "mix_lora_b": ((len(MIXES), LORA_DIM, d), (None, None, "embed"), "normal", 0.01),
            "w0": ((d,), ("embed",), "zeros", 0.0),
            "w_lora_a": ((d, LORA_DIM * 2), ("embed", None), "normal", sc),
            "w_lora_b": ((LORA_DIM * 2, d), (None, "embed"), "normal", 0.01),
            "u": ((H, dh), (None, None), "normal", 0.5),
            "ln_scale": ((d,), ("embed",), "ones", 0.0),
            "mu_ck": ((d,), ("embed",), "normal", 0.5),
            "mu_cr": ((d,), ("embed",), "normal", 0.5),
        }, dtype, device)
        kw = dict(dtype=dtype, device=device)
        for name in ("wr", "wk", "wv", "wg", "wo", "cr"):
            axes = ("q_proj", "embed") if name == "wo" else ("embed", "q_proj")
            setattr(self, name, Linear(d, d, axes, **kw))
        self.ck = Linear(d, cfg.d_ff, ("embed", "mlp"), **kw)
        self.cv = Linear(cfg.d_ff, d, ("mlp", "embed"), **kw)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Previous-token stream: shift right by one along S; position 0 takes
    ``prev`` (decode carry) or zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: TimeMix, x: torch.Tensor, xx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent token-shift mix for the five streams (RWKV6 ddlerp)."""
    base = x + (xx - x) * _scalar(0.5, x)
    lora = torch.einsum("bsd,dk->bsk", base, param(p, "mix_lora_a").to(x.dtype))
    lora = torch.tanh(lora.reshape(*x.shape[:2], len(MIXES), LORA_DIM))
    delta = torch.einsum("bsmk,mkd->bsmd", lora, param(p, "mix_lora_b").to(x.dtype))
    mu = param(p, "mu")
    return {name: x + (xx - x) * (mu[m].to(x.dtype) + delta[:, :, m])
            for m, name in enumerate(MIXES)}


def _decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    """log w_t (negative): -exp(w0 + lora(xw)); per channel, fp32.  The clip
    to [-8, 0.2] keeps the reference's chunkwise form inside fp32 range."""
    a = torch.tanh(torch.einsum("bsd,dk->bsk", xw, param(p, "w_lora_a").to(xw.dtype)))
    dd = torch.einsum("bsk,kd->bsd", a, param(p, "w_lora_b").to(xw.dtype))
    return -torch.exp(torch.clamp(param(p, "w0").float() + dd.float(), -8.0, 0.2))


def wkv6_chunked(r, k, v, logw, u, state=None, chunk: int = 64):
    """Chunkwise-parallel WKV6, as the reference's prefill: r/k/v streamed
    in bf16 (unless float64), each chunk in fp32, the state across chunks.
    r, k, v, logw: (B, T, H, dh); u: (H, dh); state: optional (B, H, dh,
    dh).  Returns (y, final_state)."""
    B, T, H, dh = r.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    out_dtype = r.dtype
    if pad:
        r, k, v, logw = (pad_zeros(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    f32 = torch.float32
    stream_dt = torch.bfloat16 if r.dtype != torch.float64 else r.dtype

    def chunks(a, dt):
        return a.reshape(B, n, chunk, H, dh).to(dt).unbind(1)

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    uf = u.to(f32)
    s = r.new_zeros((B, H, dh, dh), dtype=f32) if state is None else state.to(f32)
    ys = []
    for r_c, k_c, v_c, lw_c in zip(chunks(r, stream_dt), chunks(k, stream_dt),
                                   chunks(v, stream_dt), chunks(logw, f32)):
        r_c, k_c, v_c, lw_c = (a.to(f32) for a in (r_c, k_c, v_c, lw_c))
        cum = torch.cumsum(lw_c, dim=1)
        cum_prev = cum - lw_c
        total = cum[:, -1]
        q_tilde = r_c * torch.exp(cum_prev)
        k_tilde = k_c * torch.exp(-cum)
        # products batched over (b, h) as 4-d matmuls (heads second)
        scores = torch.matmul(q_tilde.transpose(1, 2), k_tilde.permute(0, 2, 3, 1))
        scores = torch.where(mask[None, None], scores, torch.zeros_like(scores))
        y = torch.matmul(scores, v_c.transpose(1, 2)).transpose(1, 2)
        bonus = torch.einsum("bthd,hd->bth", r_c * k_c, uf)
        y = y + bonus[..., None] * v_c
        y = y + torch.matmul(q_tilde.transpose(1, 2), s).transpose(1, 2)
        k_dec = k_c * torch.exp(total[:, None] - cum)
        s = s * torch.exp(total)[..., None] + torch.matmul(
            k_dec.permute(0, 2, 3, 1), v_c.transpose(1, 2))
        ys.append(y.to(out_dtype))
    return torch.cat(ys, dim=1)[:, :T], s


def wkv6_sequential(r, k, v, logw, u, state=None):
    """Token-by-token recurrence (the reference's oracle and decode form).
    Same signature as ``wkv6_chunked``."""
    B, T, H, dh = r.shape
    f32 = torch.float32
    s = r.new_zeros((B, H, dh, dh), dtype=f32) if state is None else state.to(f32)
    uf = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(T):
        r_t, k_t, v_t, lw_t = (a[:, t].to(f32) for a in (r, k, v, logw))
        kv = torch.einsum("bhd,bhe->bhde", k_t, v_t)
        ys.append(torch.einsum("bhd,bhde->bhe", r_t, s + uf * kv))
        s = torch.exp(lw_t)[..., None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv6_plain(r, k, v, logw, u, state=None):
    """The reference's choice of form (``apply_time_mix``): chunked for a
    sequence, sequential for one token.  Same signature as
    ``wkv6_chunked``."""
    fn = wkv6_chunked if r.shape[1] > 1 else wkv6_sequential
    return fn(r, k, v, logw, u, state)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, H: int,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head groupnorm on (B, T, d) with d = H * dh (RWKV6 ln_x)."""
    B, T, d = x.shape
    # per head, whole on each device (never split on head_dim)
    xh = constrain(split_heads(x, H, d // H), "batch", None, "heads").float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, unbiased=False)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (merge_heads(y) * scale.float()).to(x.dtype)


def _per_head(wkv: WkvFn, r, k, v, logw, u, s0):
    """``wkv(r, k, v, logw, u, s0)``; inside a sharding context on each
    device's batch rows and heads (every head there where the heads do not
    divide the model axis), r, k, v, logw, u and the state placed alike."""
    pl = placements(r)
    if pl is None:
        return wkv(r, k, v, logw, u, s0)
    from torch.distributed.tensor import Partial, Shard
    r, k, v, logw = (constrain(t, "batch", None, "heads") for t in (r, k, v, logw))
    u = constrain(u, "heads")
    s0 = None if s0 is None else constrain(s0, "batch", "heads")
    rows = placements(r)
    state = tuple(Shard(1) if isinstance(q, Shard) and q.dim == 2 else q for q in rows)
    u_grad = tuple(Partial() if isinstance(q, Shard) and q.dim == 0 else p_u
                   for q, p_u in zip(rows, placements(u)))
    grads = (rows, rows, rows, rows, u_grad, None if s0 is None else state)
    return on_shards(wkv, rows, state, grads=grads)(r, k, v, logw, u, s0)


def apply_time_mix(p: TimeMix, x: torch.Tensor, cfg,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   return_state: bool = False, wkv: WkvFn = ops.wkv6):
    """RWKV6 attention-free time-mix.  x: (B, S, d).

    state (decode): {"shift": (B, d), "wkv": (B, H, dh, dh)}.  ``wkv`` is
    the recurrence: ``kernels.ops.wkv6`` on the serving path, a plain form
    (``wkv6_sequential``) for comparisons."""
    B, S, d = x.shape
    dh = rwkv6_head_dim(cfg)
    H = d // dh
    prev = state["shift"] if state is not None else None
    xx = _token_shift(x, prev)
    mixed = _ddlerp(p, x, xx)
    r = split_heads(apply_linear(p.wr, mixed["r"]), H, dh)
    k = split_heads(apply_linear(p.wk, mixed["k"]), H, dh)
    v = split_heads(apply_linear(p.wv, mixed["v"]), H, dh)
    g = apply_linear(p.wg, mixed["g"])
    logw = split_heads(_decay(p, mixed["w"]), H, dh)
    s0 = state["wkv"] if state is not None else None
    y, s_final = _per_head(wkv, r, k, v, logw, param(p, "u"), s0)
    y = _group_norm(merge_heads(y), param(p, "ln_scale"), H)
    out = apply_linear(p.wo, y * silu(g))
    if return_state:
        return out, {"shift": x[:, -1].float().contiguous(), "wkv": s_final}
    return out


def apply_channel_mix(p: TimeMix, x: torch.Tensor, cfg,
                      state: Optional[Dict[str, torch.Tensor]] = None,
                      return_state: bool = False):
    """RWKV6 channel-mix (squared-ReLU FFN with receptance gate)."""
    prev = state["shift"] if state is not None else None
    xx = _token_shift(x, prev)
    xk = x + (xx - x) * param(p, "mu_ck").to(x.dtype)
    xr = x + (xx - x) * param(p, "mu_cr").to(x.dtype)
    kk = F.relu(apply_linear(p.ck, xk))
    vv = apply_linear(p.cv, kk * kk)
    out = torch.sigmoid(apply_linear(p.cr, xr)) * vv
    if return_state:
        return out, {"shift": x[:, -1].float().contiguous()}
    return out


def init_rwkv6_state(cfg, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dh = rwkv6_head_dim(cfg)
    H = d // dh
    f32 = torch.float32
    return {"tm_shift": torch.zeros((batch, d), dtype=f32, device=device),
            "wkv": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
            "cm_shift": torch.zeros((batch, d), dtype=f32, device=device)}
