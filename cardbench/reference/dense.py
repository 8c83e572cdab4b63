"""Plain reference of the dense decoder (Yi-34B, Llama-style), in fp32.

Written from the published description with the port's departures that
the configuration file lists (the embedding scaled by sqrt(d), RMSNorm
with ``1 + scale``).  Imports torch alone: no kernel, cache or batching of
the program.  ``logits`` runs each request's whole sequence (prompt and
served tokens) through the stack layer by layer, in blocks of queries, and
returns the logits at the positions whose next token was served.

``precision="fp8"`` is the control: every weight and every input of a
product is rounded to float8 e4m3 with one scale per tensor (per expert for
stacked experts) and computed in fp32 from there; norms, softmax and
attention stay fp32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Weights = Dict[str, torch.Tensor]
FP8_MAX = 448.0
Q_BLOCK = 512


def fp8(x: torch.Tensor, dims: Tuple[int, ...] = ()) -> torch.Tensor:
    """x rounded to float8 e4m3 (scaled to its amax over all but ``dims``)."""
    red = [i for i in range(x.dim()) if i not in dims]
    amax = x.abs().amax(dim=red, keepdim=True) if red else x.abs()
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def prepare(w: Weights, precision: str) -> Weights:
    """fp32 copies of a group's weights (float8-rounded for the control)."""
    out = {}
    for name, t in w.items():
        t = t.float()
        if precision == "fp8" and t.dim() >= 2:
            t = fp8(t, (0,) if t.dim() == 3 else ())
        out[name] = t
    return out


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        x = fp8(x)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, dh) at positions 0..S-1; rotation of the two halves."""
    S, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """Causal grouped-query attention; q (S, H, dh), k/v (S, K, dh); with
    ``window`` a query at p sees keys p - window + 1 .. p."""
    S, H, dh = q.shape
    K = k.shape[1]
    G = H // K
    qg = q.view(S, K, G, dh) / math.sqrt(dh)
    out = torch.empty_like(q)
    for a in range(0, S, Q_BLOCK):
        b = min(a + Q_BLOCK, S)
        lo = max(0, a - window + 1) if window else 0
        s = torch.einsum("qkgd,skd->kgqs", qg[a:b], k[lo:b])
        qp = torch.arange(a, b, device=q.device)[:, None]
        kp = torch.arange(lo, b, device=q.device)[None, :]
        ok = kp <= qp
        if window:
            ok &= kp > qp - window
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgqs,skd->qkgd", p, v[lo:b]).reshape(b - a, H, dh)
    return out


def attention_block(x: torch.Tensor, w: Weights, p: str, cfg: dict,
                    precision: str) -> torch.Tensor:
    S, d = x.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // H
    theta = cfg["rope_theta"]
    q = rope(matmul(x, w[p + "attn.wq.w"], precision).view(S, H, dh), theta)
    k = rope(matmul(x, w[p + "attn.wk.w"], precision).view(S, K, dh), theta)
    v = matmul(x, w[p + "attn.wv.w"], precision).view(S, K, dh)
    o = attention(q, k, v, cfg.get("sliding_window") or 0)
    return matmul(o.reshape(S, H * dh), w[p + "attn.wo.w"], precision)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mlp(x: torch.Tensor, w: Weights, p: str, cfg: dict, n_prompt: int,
        precision: str) -> torch.Tensor:
    h = silu(matmul(x, w[p + "mlp.wi.w"], precision)) * matmul(x, w[p + "mlp.wg.w"], precision)
    return matmul(h, w[p + "mlp.wo.w"], precision)


FFN = Callable[[torch.Tensor, Weights, str, dict, int, str], torch.Tensor]


def logits(cfg: dict, draw: Callable[[str], Weights],
           requests: Sequence[Tuple[torch.Tensor, int]], *, precision: str = "fp32",
           ffn: FFN = mlp) -> List[torch.Tensor]:
    """Logits (fp32) of each request at the positions n_prompt - 1 .. end.

    ``requests``: (ids, n_prompt) pairs, ids the prompt followed by every
    served token but the last (so position n_prompt - 1 + j predicts
    served token j).  ``draw(group)`` gives a weight group ("embed",
    "layers.<i>", "head") as the benchmark drew it."""
    eps = cfg["rms_norm_eps"]
    d = cfg["hidden_size"]
    table = prepare(draw("embed"), precision)["embed.table"]
    hs = [table[ids] * math.sqrt(d) for ids, _ in requests]
    del table
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        w = prepare(draw(f"layers.{i}"), precision)
        for r, (_, n_prompt) in enumerate(requests):
            x = hs[r]
            x = x + attention_block(rms_norm(x, w[p + "ln1.scale"], eps), w, p, cfg, precision)
            hs[r] = x + ffn(rms_norm(x, w[p + "ln2.scale"], eps), w, p, cfg, n_prompt,
                            precision)
        del w
    w = prepare(draw("head"), precision)
    out = []
    for x, (_, n_prompt) in zip(hs, requests):
        h = rms_norm(x[n_prompt - 1:], w["final_norm.scale"], eps)
        out.append(matmul(h, w["logits.w"], precision))
    return out
