"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch (PyTorch).

Counterpart of ``repro/models/moe.py``.  Dispatch is computed per batch
row; capacity follows GShard, C = ceil(S * top_k * capacity_factor / E),
and assignments past an expert's capacity drop to the residual path.  The
reference computes the whole block with jnp outside any Pallas kernel, so
the port's expert products are ``torch.einsum`` and its combine is
``index_add``, all under autograd (the training forward runs it too).
The reference's sharding hints are kept: ``constrain`` pins the dispatched
tokens, the expert activations and, under ``cfg.expert_parallel``, the
all-to-all back to token-major, on DTensors inside a
``runtime.sharding_context``, and changes no value.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import constrain, on_shards, placements
from .layers import Linear, _act, apply_linear, param, raw_params


class MoE(nn.Module):
    """Router ``router.w`` (d, E) and the experts' stacked weights ``wi``,
    ``wg`` (E, d, f) and ``wo`` (E, f, d): the reference's ``moe/router/w``,
    ``moe/wi``, ``moe/wg``, ``moe/wo`` (``moe_spec``)."""

    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        eax = "experts_ep" if cfg.expert_parallel else "experts"
        # EP weights drop FSDP on the embed dim (they are already data-sharded
        # over the expert dim; double-sharding would regather per layer)
        dax = None if cfg.expert_parallel else "embed"
        self.router = Linear(d, E, ("embed", None), dtype=dtype, device=device)
        specs = {"wi": ((E, d, f), (eax, dax, "mlp"), "normal", 1.0 / math.sqrt(d))}
        if cfg.mlp_act.endswith("_glu"):
            specs["wg"] = ((E, d, f), (eax, dax, "mlp"), "normal", 1.0 / math.sqrt(d))
        specs["wo"] = ((E, f, d), (eax, "mlp", dax), "normal", 1.0 / math.sqrt(f))
        raw_params(self, specs, dtype, device)


def capacity(cfg, seq: int) -> int:
    """Slots per expert and batch row for ``seq`` tokens."""
    c = math.ceil(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(int(c), 1)


def route(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing: router logits in x's dtype, softmax in fp32, the k
    largest probabilities (ties to the lower expert, as ``lax.top_k``)
    renormalized to sum to 1.  Returns (weights (B, S, k) in x's dtype,
    experts (B, S, k) int64)."""
    logits = apply_linear(p.router, x)
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :cfg.top_k], topi[..., :cfg.top_k]
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    return topw.to(x.dtype), topi


def dispatch(topi: torch.Tensor, C: int, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's slot rule.  Assignments are taken token-major and
    k-minor; each one's queue slot in its expert is the count of earlier
    assignments to that expert.  Returns (slot (B, S*k), keep (B, S*k):
    slot < C)."""
    B, S, k = topi.shape
    onehot = F.one_hot(topi.reshape(B, S * k), E)                 # (B, S*k, E)
    slot = torch.amax(torch.cumsum(onehot, dim=1) * onehot - 1, dim=-1)
    return slot, slot < C


def apply_moe(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Kept assignments fill (B, E, C) buffers
    of token ids and weights; slots never filled point at the pad row S,
    whose zeros vanish in the combine.  Dropped assignments are written to
    a spare column C that is cut off, so they never overwrite a kept
    slot."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    # dispatch and combine are per batch row: inside a sharding context
    # they run on each device's rows (``runtime.on_shards``), the expert
    # products between them on DTensors
    x = constrain(x, "batch")
    topw, topi = route(p, x, cfg)
    topw, topi = constrain(topw, "batch"), constrain(topi, "batch")
    rows = placements(x)

    def gather(x: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor):
        B = x.shape[0]
        slot, keep = dispatch(topi, C, E)
        dev = x.device
        b_ix = torch.arange(B, device=dev)[:, None].expand(B, S * k)
        e_ix = topi.reshape(B, S * k)
        c_ix = torch.where(keep, slot, torch.full_like(slot, C))
        token_of = torch.arange(S, device=dev).repeat_interleave(k).expand(B, S * k)
        disp = torch.full((B, E, C + 1), S, dtype=torch.long, device=dev)
        disp[b_ix, e_ix, c_ix] = token_of
        disp = disp[..., :C].reshape(B, E * C)
        wbuf = x.new_zeros((B, E, C + 1))
        wbuf[b_ix, e_ix, c_ix] = topw.reshape(B, S * k)
        wbuf = wbuf[..., :C]
        x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
        xe = x_pad[torch.arange(B, device=dev)[:, None], disp].reshape(B, E, C, d)
        return xe, wbuf, disp

    def combine(ye: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        # scatter-add back to token positions (pad row S absorbs the empty
        # slots)
        B = ye.shape[0]
        flat_ix = (torch.arange(B, device=ye.device)[:, None] * (S + 1)
                   + disp).reshape(B * E * C)
        out = ye.new_zeros((B * (S + 1), d)).index_add(0, flat_ix,
                                                      ye.reshape(B * E * C, d))
        return out.reshape(B, S + 1, d)[:, :S]

    xe, wbuf, disp = on_shards(gather, rows, rows, rows)(x, topw, topi)
    if cfg.expert_parallel:
        # EP: reshard tokens expert-major (all-to-all) so the expert GEMMs
        # run where the weights live; batch dim replicates locally
        xe = constrain(xe, None, "experts_ep")
    else:
        xe = constrain(xe, "batch", "experts")
    h = torch.einsum("becd,edf->becf", xe, param(p, "wi").to(x.dtype))
    if cfg.expert_parallel:
        h = constrain(h, None, "experts_ep", None, "mlp")
    else:
        h = constrain(h, "batch", "experts", None, "mlp")
    h = _act(h, cfg.mlp_act)
    if cfg.mlp_act.endswith("_glu"):
        h = h * torch.einsum("becd,edf->becf", xe, param(p, "wg").to(x.dtype))
    ye = torch.einsum("becf,efd->becd", h, param(p, "wo").to(x.dtype))
    if cfg.expert_parallel:
        ye = constrain(ye, "batch", None)   # all-to-all back to token-major
    ye = constrain(ye * wbuf[..., None], "batch")
    return on_shards(combine, rows)(ye, disp)
