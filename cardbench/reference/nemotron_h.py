"""Plain reference of the hybrid Mamba-2 stack (Nemotron-H), in fp32.

Written from the published layer equations (Nemotron-H, arXiv:2504.03624;
Mamba-2, arXiv:2405.21060) with the port's departures that the
configuration file lists (the embedding scaled by sqrt(d), every RMSNorm
``1 + scale`` with eps 1e-6).  Imports torch alone: no kernel, cache or
batching of the program.  Layer i is ``h + mixer(RMSNorm(h))``, the mixer
the kind ``hybrid_override_pattern[i]`` names:

- ``M``, Mamba-2: ``[z, xBC, dt] = x W_in``; xBC through the causal
  depthwise conv (with bias) and SiLU; ``[x, B, C] = split(xBC)``;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head h of
  group g = h // (H / G), one token at a time,
  ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t (outer) B_t``,
  ``y_t = S_t C_t + D x_t``; then RMSNorm over G groups of
  ``y * SiLU(z)``, times ``1 + scale``, and ``W_out``.  The recurrence is
  run step by step, as written, never in the chunked form of the
  program's prefill.
- ``*``, causal GQA attention with no position embedding and no bias.
- ``-``, ``W_down relu(W_up x)^2``.

``logits`` runs each request's whole sequence (prompt and served tokens)
through the stack, drawing one layer at a time (the fp32 model whole
would be 97.6 GB), the requests of one length together, and returns the
logits at the positions whose next token was served.

``precision="fp8"`` is the control: every weight and every input of a
product is rounded to float8 e4m3 with one scale per tensor
(``dense.fp8``) and computed in fp32 from there; norms, the conv's SiLU,
the recurrence and the attention's softmax stay fp32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .dense import Weights, attention, matmul, prepare, rms_norm, silu

EPS = 1e-6          # the port's, for every norm (the configuration's departure)
KIND_OF = {"M": "mamba2", "-": "mlp", "*": "attn"}


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """The recurrence from a zero state, one token at a time.  x (R, T, H,
    P), dt (R, T, H), A and D (H,), B and C (R, T, G, N) -> y (R, T, H, P)."""
    R, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    group = torch.arange(H, device=x.device) // (H // G)
    state = x.new_zeros((R, H, P, N))
    y = torch.empty_like(x)
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)                                 # (R, H)
        u = dt[:, t, :, None] * x[:, t]                                 # (R, H, P)
        state.mul_(decay[..., None, None])
        state.addcmul_(u[..., None], B[:, t][:, group][:, :, None, :])
        y[:, t] = torch.matmul(state, C[:, t][:, group][..., None])[..., 0] \
            + D[:, None] * x[:, t]
    return y


def mamba2(x: torch.Tensor, w: Weights, p: str, cfg: dict, precision: str) -> torch.Tensor:
    R, T, _ = x.shape
    H, P, G, N = (cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"],
                  cfg["ssm_state_size"])
    di, taps = H * P, cfg["conv_kernel"]
    z, xbc, dt = torch.split(matmul(x, w[p + "in_proj.w"], precision),
                             [di, di + 2 * G * N, H], dim=-1)
    conv = w[p + "conv_b"].expand_as(xbc).clone()
    for j in range(taps):               # tap j reads the input taps - 1 - j steps back
        back = taps - 1 - j
        conv[:, back:] += w[p + "conv_w"][:, j] * xbc[:, :T - back]
    del xbc
    xs, Bm, Cm = torch.split(silu(conv), [di, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(dt + w[p + "dt_bias"])
    y = ssm_scan(xs.reshape(R, T, H, P), dt, -torch.exp(w[p + "A_log"]),
                 Bm.reshape(R, T, G, N), Cm.reshape(R, T, G, N), w[p + "D"])
    del conv, xs, Bm, Cm
    g = (y.reshape(R, T, di) * silu(z)).reshape(R, T, G, di // G)
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + EPS)
    g = g.reshape(R, T, di) * (1.0 + w[p + "norm.scale"])
    return matmul(g, w[p + "out_proj.w"], precision)


def attention_layer(x: torch.Tensor, w: Weights, p: str, cfg: dict,
                    precision: str) -> torch.Tensor:
    R, T, _ = x.shape
    H, K, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["attention_head_dim"]
    q = matmul(x, w[p + "wq.w"], precision).view(R, T, H, dh)
    k = matmul(x, w[p + "wk.w"], precision).view(R, T, K, dh)
    v = matmul(x, w[p + "wv.w"], precision).view(R, T, K, dh)
    o = torch.stack([attention(q[r], k[r], v[r], 0) for r in range(R)])
    return matmul(o.reshape(R, T, H * dh), w[p + "wo.w"], precision)


def mlp(x: torch.Tensor, w: Weights, p: str, precision: str) -> torch.Tensor:
    h = torch.relu(matmul(x, w[p + "wi.w"], precision))
    return matmul(h * h, w[p + "wo.w"], precision)


def run(cfg: dict, draw: Callable[[str], Weights], ids: torch.Tensor,
        precision: str) -> torch.Tensor:
    """Final hidden states (R, T, d) of the requests ``ids`` (R, T)."""
    table = prepare(draw("embed"), precision)["embed.table"]
    h = table[ids] * math.sqrt(cfg["hidden_size"])
    del table
    for i, c in enumerate(cfg["hybrid_override_pattern"]):
        p = f"layers.{i}."
        w = prepare(draw(f"layers.{i}"), precision)
        x = rms_norm(h, w[p + "ln1.scale"], EPS)
        kind = KIND_OF[c]
        if kind == "mamba2":
            h = h + mamba2(x, w, p + "mamba.", cfg, precision)
        elif kind == "attn":
            h = h + attention_layer(x, w, p + "attn.", cfg, precision)
        else:
            h = h + mlp(x, w, p + "mlp.", precision)
        del w, x
    return h


def logits(cfg: dict, draw: Callable[[str], Weights],
           requests: Sequence[Tuple[torch.Tensor, int]], *,
           precision: str = "fp32") -> List[torch.Tensor]:
    """Logits (fp32) of each request at the positions n_prompt - 1 .. end.

    ``requests``: (ids, n_prompt) pairs, ids the prompt followed by every
    served token but the last (so position n_prompt - 1 + j predicts
    served token j).  ``draw(group)`` gives a weight group ("embed",
    "layers.<i>", "head") as the benchmark drew it.  Requests of one length
    run together, each layer drawn once for them."""
    if len(cfg["hybrid_override_pattern"]) != cfg["num_hidden_layers"]:
        raise ValueError("the pattern does not name every layer")
    by_len: Dict[int, List[int]] = {}
    for r, (ids, _) in enumerate(requests):
        by_len.setdefault(ids.numel(), []).append(r)
    hidden: Dict[int, torch.Tensor] = {}
    for rows in by_len.values():
        h = run(cfg, draw, torch.stack([requests[r][0] for r in rows]), precision)
        hidden.update({r: h[j, requests[r][1] - 1:] for j, r in enumerate(rows)})
        del h
    w = prepare(draw("head"), precision)
    return [matmul(rms_norm(hidden[r], w["final_norm.scale"], EPS), w["logits.w"], precision)
            for r in range(len(requests))]
