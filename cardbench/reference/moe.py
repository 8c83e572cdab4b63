"""Plain reference of the sparse-expert decoder (Mixtral 8x7B), in fp32.

The dense reference with its feed-forward replaced by the routed experts:
router logits, softmax, the top 2 experts (ties to the lower index)
renormalised, each expert a SiLU-gated feed-forward, their outputs summed
with the routing weights.  Routing departs from published Mixtral as the
configuration file states: a prefill of S tokens gives each expert
C = ceil(S * k * capacity_factor / E) slots, assignments are taken
token-major and k-minor, and those past C add nothing.  The prompt is one
such prefill; every served token after it is a one-token step of its own
(C = ceil(k * capacity_factor / E) >= 1, and its k experts are distinct,
so each takes slot 0).
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

from . import dense
from .dense import Weights, matmul, silu


def route(x: torch.Tensor, w: Weights, p: str, cfg: dict, precision: str):
    """(weights (S, k), experts (S, k)) of each token."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(matmul(x, w[p + "moe.router.w"], precision), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    return top_w / top_w.sum(dim=-1, keepdim=True), top_i


def kept(top_i: torch.Tensor, n_prompt: int, cfg: dict) -> torch.Tensor:
    """(S, k) bool: which assignments find a slot.  Over the prompt each
    expert's assignments are counted in token-major, k-minor order and
    those at count >= C are dropped; each later token is alone."""
    S, k = top_i.shape
    E = cfg["num_local_experts"]
    cap = cfg["assumed"]["capacity_factor"]
    keep = torch.ones((S, k), dtype=torch.bool, device=top_i.device)
    flat = top_i[:n_prompt].reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, E)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep[:n_prompt] = (slot < math.ceil(n_prompt * k * cap / E)).view(n_prompt, k)
    return keep     # a lone token's k distinct experts each take slot 0 < C


def experts(x: torch.Tensor, w: Weights, p: str, cfg: dict, n_prompt: int,
            precision: str) -> torch.Tensor:
    top_w, top_i = route(x, w, p, cfg, precision)
    keep = kept(top_i, n_prompt, cfg)
    experts.dropped += int((~keep).sum())
    out = torch.zeros_like(x)
    for e in range(cfg["num_local_experts"]):
        tok, slot = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = silu(matmul(xe, w[p + "moe.wi"][e], precision)) \
            * matmul(xe, w[p + "moe.wg"][e], precision)
        y = matmul(h, w[p + "moe.wo"][e], precision)
        out.index_add_(0, tok, y * top_w[tok, slot][:, None])
    return out


experts.dropped = 0     # assignments dropped by capacity, summed over calls


def logits(cfg: dict, draw: Callable[[str], Weights],
           requests: Sequence[Tuple[torch.Tensor, int]], *,
           precision: str = "fp32") -> List[torch.Tensor]:
    """As ``dense.logits``, through the experts."""
    return dense.logits(cfg, draw, requests, precision=precision, ffn=experts)
