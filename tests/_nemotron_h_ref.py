"""Plain fp32 reference of the Nemotron-H stack for the port's CPU tests.

Written from the layer equations (Nemotron-H, arXiv:2504.03624; Mamba-2,
arXiv:2405.21060) with the port's conventions: the embedding scaled by
sqrt(d), every RMSNorm ``1 + scale`` with ``eps``.  Imports torch alone:
nothing of the port, nothing of JAX.  The Mamba-2 recurrence runs token by
token, as its equations are written, never in the chunked form the
program's prefill uses.  ``cfg`` is read by attribute (the port's
``HybridConfig`` serves), ``w`` by the port's parameter names.
"""
import math
from typing import Dict

import torch

Weights = Dict[str, torch.Tensor]
EPS = 1e-6      # the port's RMSNorm eps, the gated norm's too


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def ssm_scan(x, dt, A, B, C, D, state=None):
    """The recurrence over t, one step at a time.  x (b, S, H, P), dt (b, S,
    H), A and D (H,), B and C (b, S, G, N); head h reads group h // (H / G).
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t (outer) B_t;  y_t = S_t C_t + D x_t.
    Returns (y (b, S, H, P), the last state (b, H, P, N))."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    group = torch.arange(H) // (H // G)
    if state is None:
        state = torch.zeros((b, H, P, N), dtype=torch.float32)
    ys = []
    for t in range(S):
        Bt, Ct = B[:, t][:, group], C[:, t][:, group]                # (b, H, N)
        decay = torch.exp(dt[:, t] * A)                                # (b, H)
        state = decay[..., None, None] * state \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bt[:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ct) + D[:, None] * x[:, t])
    return torch.stack(ys, dim=1), state


def mamba2(x: torch.Tensor, w: Weights, p: str, cfg) -> torch.Tensor:
    b, S, _ = x.shape
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    di = H * P
    z, xbc, dt = torch.split(x @ w[p + "in_proj.w"], [di, di + 2 * G * N, H], dim=-1)
    cw, taps = w[p + "conv_w"], cfg.conv_width
    conv = w[p + "conv_b"].expand_as(xbc).clone()
    for j in range(taps):           # tap j reads the input taps - 1 - j steps back
        back = taps - 1 - j
        conv[:, back:] += cw[:, j] * xbc[:, :S - back]
    xs, Bm, Cm = torch.split(silu(conv), [di, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(dt + w[p + "dt_bias"])
    A = -torch.exp(w[p + "A_log"])
    y, _ = ssm_scan(xs.reshape(b, S, H, P), dt, A, Bm.reshape(b, S, G, N),
                    Cm.reshape(b, S, G, N), w[p + "D"])
    g = (y.reshape(b, S, di) * silu(z)).reshape(b, S, G, di // G)
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + EPS)
    g = g.reshape(b, S, di) * (1.0 + w[p + "norm.scale"])
    return g @ w[p + "out_proj.w"]


def attention(x: torch.Tensor, w: Weights, p: str, cfg) -> torch.Tensor:
    """Causal GQA, no position embedding, no bias."""
    b, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ w[p + "wq.w"]).reshape(b, S, H, dh)
    k = (x @ w[p + "wk.w"]).reshape(b, S, K, dh).repeat_interleave(H // K, dim=2)
    v = (x @ w[p + "wv.w"]).reshape(b, S, K, dh).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(b, S, H * dh) @ w[p + "wo.w"]


def mlp(x: torch.Tensor, w: Weights, p: str) -> torch.Tensor:
    return torch.relu(x @ w[p + "wi.w"]) ** 2 @ w[p + "wo.w"]


def forward(cfg, w: Weights, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (b, S, V) of every position of ``tokens`` (b, S)."""
    w = {k: v.float() for k, v in w.items()}
    h = w["embed.table"][tokens] * math.sqrt(cfg.d_model)
    for i, kind in enumerate(cfg.layer_kinds):
        p = f"layers.{i}."
        x = rms_norm(h, w[p + "ln1.scale"], EPS)
        if kind == "mamba2":
            h = h + mamba2(x, w, p + "mamba.", cfg)
        elif kind == "attn":
            h = h + attention(x, w, p + "attn.", cfg)
        else:
            h = h + mlp(x, w, p + "mlp.")
    return rms_norm(h, w["final_norm.scale"], EPS) @ w["logits.w"]
