"""Transformer stack of the port: the ``"global"`` (dense GQA) block.

Counterpart of ``repro/models/transformer.py`` for prefill with KV-cache
collection and single-token decode.  The reference scans over layers
stacked on a leading axis; here each layer is one ``Block`` in an
``nn.ModuleList`` and the scan is a loop (``models.model``).  The other
block kinds raise ``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import (MLP, Attention, Norm, apply_linear, apply_mlp,
                     apply_norm, attention_decode, rope, torch_dtype)

PORTED_KINDS = ("global",)

Cache = List[Dict[str, torch.Tensor]]   # one {"k", "v"} per layer
AttentionFn = Callable[..., torch.Tensor]


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: local/moe/rec/rwkv "
            "blocks land with the dense-variant, MoE, RG-LRU and RWKV-6 "
            "slices of the port")


def group_meta(cfg: ModelConfig) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
    """((unit kinds, n_repeats), ...) covering cfg.n_layers in order — the
    reference's stacking, used to map its keypaths onto layers."""
    unit = cfg.block_pattern
    n_full, leftover = divmod(cfg.n_layers, len(unit))
    groups: List[Tuple[Tuple[str, ...], int]] = []
    if n_full:
        groups.append((unit, n_full))
    if leftover:
        groups.append((unit[:leftover], 1))
    return tuple(groups)


class Block(nn.Module):
    """Pre-norm attention + MLP block (kind ``"global"``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device="cpu"):
        super().__init__()
        check_kind(kind)
        dtype = torch_dtype(cfg.param_dtype)
        self.kind = kind
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def block_forward(kind: str, p: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, collect_cache: int,
                  attention: AttentionFn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill through one block; returns (x, its KV cache padded to
    ``collect_cache`` positions).  ``attention`` computes causal GQA on
    (B, S, H, dh) / (B, S, K, dh): ``kernels.ops.attention`` on the serving
    path, ``layers.mha`` for the plain comparison."""
    check_kind(kind)
    h_in = apply_norm(p.ln1, x, cfg.norm)
    h, cache = _attention_with_cache(p.attn, h_in, cfg, positions,
                                     collect_cache, attention)
    x = x + h
    x = x + apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg.norm), cfg)
    return x, cache


def _attention_with_cache(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, s_buf: int,
                          attention: AttentionFn):
    """Prefill attention that also emits the KV cache buffer."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = apply_linear(p.wq, x).reshape(B, S, H, dh)
    k = apply_linear(p.wk, x).reshape(B, S, K, dh)
    v = apply_linear(p.wv, x).reshape(B, S, K, dh)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=True, softcap=cfg.attn_softcap,
                    scale=cfg.query_scale)
    y = apply_linear(p.wo, out.reshape(B, S, H * dh))
    kc = k.new_zeros((B, s_buf, K, dh))
    vc = v.new_zeros((B, s_buf, K, dh))
    kc[:, :S] = k
    vc[:, :S] = v
    return y, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Decode (single token)
# ---------------------------------------------------------------------------

def block_decode(kind: str, p: Block, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                 pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through one block; the layer's cache is updated in place."""
    check_kind(kind)
    h, cache = attention_decode(p.attn, apply_norm(p.ln1, x, cfg.norm),
                                cache, cfg, pos=pos)
    x = x + h
    x = x + apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg.norm), cfg)
    return x, cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def layer_cache_shape(cfg: ModelConfig, kind: str, batch: int,
                      s_buf: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each tensor of one layer's decode cache."""
    check_kind(kind)
    spec = ((batch, s_buf, cfg.n_kv_heads, cfg.d_head),
            torch_dtype(cfg.compute_dtype))
    return {"k": spec, "v": spec}


def init_cache(cfg: ModelConfig, batch: int, s_buf: int, device="cpu") -> Cache:
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in
             layer_cache_shape(cfg, kind, batch, s_buf).items()}
            for kind in cfg.layer_kinds]
