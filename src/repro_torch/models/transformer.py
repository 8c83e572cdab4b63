"""Transformer stack of the port: the ``"global"``, ``"local"``, ``"rec"``
and ``"rwkv"`` blocks.

Counterpart of ``repro/models/transformer.py`` for prefill with decode-cache
collection and single-token decode.  The reference scans over layers
stacked on a leading axis; here each layer is one ``Block`` in an
``nn.ModuleList`` and the scan is a loop (``models.model``).  The MoE block
kinds raise ``NotImplementedError`` until their slice lands.

Every kernel of a block comes from a :class:`Kernels` bundle: ``KERNELS``
(``kernels.ops``: the Hopper kernels on the card, their plain versions on
the CPU) on the serving path, ``PLAIN`` (the models' own plain forms) for
comparisons on any device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from ..kernels import ops
from .config import ModelConfig
from .layers import (MLP, Attention, Norm, apply_linear, apply_mlp,
                     apply_norm, attention_decode, mha, rope, torch_dtype)
from .rglru import (RGLRU, apply_rglru, init_rglru_state, rglru_decode,
                    rglru_scan)
from .rwkv6 import (TimeMix, apply_channel_mix, apply_time_mix,
                    init_rwkv6_state, wkv6_sequential)

PORTED_KINDS = ("global", "local", "rec", "rwkv")

Cache = List[Dict[str, torch.Tensor]]   # one dict of state tensors per layer
AttentionFn = Callable[..., torch.Tensor]


class Kernels(NamedTuple):
    """The functions a block's kernels stand for: causal GQA attention on
    (B, S, H, dh) / (B, S, K, dh); the WKV6 recurrence ``(r, k, v, logw, u,
    s0) -> (y, s_final)``; the RG-LRU scan ``(a, b, h0) -> h``."""
    attention: AttentionFn
    wkv6: Callable
    rglru_scan: Callable


KERNELS = Kernels(ops.attention, ops.wkv6, ops.rglru_scan)
PLAIN = Kernels(mha, wkv6_sequential, rglru_scan)


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: moe blocks land with the "
            "MoE slice of the port")


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "local" else 0


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
    """Pre-norm block: attention + MLP (``"global"``, ``"local"``), RG-LRU +
    MLP (``"rec"``), or RWKV6 time-mix + channel-mix (``"rwkv"``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device="cpu"):
        super().__init__()
        check_kind(kind)
        dtype = torch_dtype(cfg.param_dtype)
        self.kind = kind
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        if kind == "rwkv":
            self.tm = TimeMix(cfg, dtype, device)
            return
        if kind == "rec":
            self.rec = RGLRU(cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def block_forward(kind: str, p: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, collect_cache: int,
                  kernels: Kernels = KERNELS
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill through one block; returns (x, its decode cache; attention
    caches hold ``collect_cache`` positions, or a ring of ``cfg.window``)."""
    check_kind(kind)
    h_in = apply_norm(p.ln1, x, cfg.norm)
    if kind == "rwkv":
        h, st = apply_time_mix(p.tm, h_in, cfg, return_state=True,
                               wkv=kernels.wkv6)
        x = x + h
        h2, st2 = apply_channel_mix(p.tm, apply_norm(p.ln2, x, cfg.norm), cfg,
                                    return_state=True)
        return x + h2, {"tm_shift": st["shift"], "wkv": st["wkv"],
                        "cm_shift": st2["shift"]}
    if kind == "rec":
        h, cache = apply_rglru(p.rec, h_in, cfg, return_state=True,
                               scan=kernels.rglru_scan)
    else:
        h, cache = _attention_with_cache(p.attn, h_in, cfg, positions,
                                         _window(cfg, kind), collect_cache,
                                         kernels.attention)
    x = x + h
    x = x + apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg.norm), cfg)
    return x, cache


def _attention_with_cache(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, window: int, s_buf: int,
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
    out = attention(q, k, v, causal=True, window=window,
                    softcap=cfg.attn_softcap, scale=cfg.query_scale)
    y = apply_linear(p.wo, out.reshape(B, S, H * dh))
    if window and window < s_buf:
        # ring buffer holding the last `window` positions at slot p % window
        lo = max(S - window, 0)
        slots = torch.arange(lo, S, device=x.device) % window
        kc = k.new_zeros((B, window, K, dh))
        vc = v.new_zeros((B, window, K, dh))
        kc[:, slots] = k[:, lo:]
        vc[:, slots] = v[:, lo:]
    else:
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
                 pos: int, kernels: Kernels = KERNELS
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through one block; the layer's cache dict is updated in
    place (attention K/V written into their buffers, recurrent states
    replaced)."""
    check_kind(kind)
    h_in = apply_norm(p.ln1, x, cfg.norm)
    if kind == "rwkv":
        h, st = apply_time_mix(p.tm, h_in, cfg,
                               state={"shift": cache["tm_shift"], "wkv": cache["wkv"]},
                               return_state=True, wkv=kernels.wkv6)
        cache["tm_shift"], cache["wkv"] = st["shift"], st["wkv"]
        x = x + h
        h2, st2 = apply_channel_mix(p.tm, apply_norm(p.ln2, x, cfg.norm), cfg,
                                    state={"shift": cache["cm_shift"]},
                                    return_state=True)
        cache["cm_shift"] = st2["shift"]
        return x + h2, cache
    if kind == "rec":
        h, st = rglru_decode(p.rec, h_in, cfg, cache, scan=kernels.rglru_scan)
        cache.update(st)
    else:
        h, cache = attention_decode(p.attn, h_in, cache, cfg, pos=pos,
                                    window=_window(cfg, kind))
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
    f32 = torch.float32
    if kind == "rwkv":
        return {name: (tuple(t.shape), t.dtype)
                for name, t in init_rwkv6_state(cfg, batch, "meta").items()}
    if kind == "rec":
        return {name: (tuple(t.shape), f32)
                for name, t in init_rglru_state(cfg, batch, "meta").items()}
    window = _window(cfg, kind)
    n = min(window, s_buf) if window else s_buf
    spec = ((batch, n, cfg.n_kv_heads, cfg.d_head), torch_dtype(cfg.compute_dtype))
    return {"k": spec, "v": spec}


def init_cache(cfg: ModelConfig, batch: int, s_buf: int, device="cpu") -> Cache:
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in
             layer_cache_shape(cfg, kind, batch, s_buf).items()}
            for kind in cfg.layer_kinds]
