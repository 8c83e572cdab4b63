"""Transformer stack of the port: the ``"global"``, ``"local"``, ``"rec"``
and ``"rwkv"`` blocks.

Counterpart of ``repro/models/transformer.py``: the training forward
(``run_stack``, under autograd with per-layer rematerialization), prefill
with decode-cache collection (``run_stack_prefill``) and single-token
decode (``run_stack_decode``).  The reference scans over layers stacked on
a leading axis; here each layer is one ``Block`` in an ``nn.ModuleList``
and the scan is a loop over the same groups (``group_meta``).  The MoE
block kinds raise ``NotImplementedError`` until their slice lands.

Every kernel of a serving block comes from a :class:`Kernels` bundle:
``KERNELS`` (``kernels.ops``: the Hopper kernels on the card, their plain
versions on the CPU) on the serving path, ``PLAIN`` (the models' own plain
forms) for comparisons on any device.  Training takes no bundle: it runs
the plain forms the reference trains with (``mha``, ``wkv6_chunked``, the
associative ``rglru_scan``), since the kernels have no backward.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .config import ModelConfig
from .layers import (MLP, Attention, Norm, apply_linear, apply_mlp,
                     apply_norm, attention_block, attention_decode, mha, rope,
                     torch_dtype)
from .rglru import (RGLRU, apply_rglru, init_rglru_state, rglru_decode,
                    rglru_scan)
from .rwkv6 import (TimeMix, apply_channel_mix, apply_time_mix,
                    init_rwkv6_state, wkv6_chunked, wkv6_sequential)

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
# Forward blocks (training / prefill)
# ---------------------------------------------------------------------------

def block_forward(kind: str, p: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, collect_cache: Optional[int] = None,
                  kernels: Kernels = KERNELS
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One block; returns (x, its decode cache or None).  ``collect_cache``:
    the prefill's KV buffer length (attention caches hold that many
    positions, or a ring of ``cfg.window``), through ``kernels``; None
    during training, which runs the plain forms under autograd."""
    check_kind(kind)
    if collect_cache is None:
        return _train_block(kind, p, x, cfg, positions), None
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


def _train_block(kind: str, p: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """The reference's ``collect_cache=None`` branch, with its plain forms:
    jnp-style ``mha``, chunked WKV6 for S > 1 (sequential for one token),
    the associative RG-LRU scan."""
    h_in = apply_norm(p.ln1, x, cfg.norm)
    if kind == "rwkv":
        wkv = wkv6_chunked if x.shape[1] > 1 else wkv6_sequential
        x = x + apply_time_mix(p.tm, h_in, cfg, wkv=wkv)
        return x + apply_channel_mix(p.tm, apply_norm(p.ln2, x, cfg.norm), cfg)
    if kind == "rec":
        h = apply_rglru(p.rec, h_in, cfg, scan=rglru_scan)
    else:
        h = attention_block(p.attn, h_in, cfg, positions=positions,
                            window=_window(cfg, kind))
    x = x + h
    return x + apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg.norm), cfg)


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


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _split_factor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n) (two-level remat split)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best


def _groups(layers: Sequence[Block], cfg: ModelConfig):
    """Per group of ``group_meta``: its repetitions, each the list of the
    unit's layers."""
    start = 0
    for unit, n in group_meta(cfg):
        u = len(unit)
        yield [list(layers[start + r * u:start + (r + 1) * u]) for r in range(n)]
        start += n * u


def run_stack(layers: Sequence[Block], x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Training forward through all groups, under autograd.

    With ``remat`` each repetition of a group's unit is checkpointed (the
    reference's ``nothing_saveable`` scan body: only its input is kept, the
    rest is recomputed in the backward).  Groups of n >= 9 repetitions take
    the reference's two-level split: checkpointed runs of n_inner
    repetitions over checkpointed repetitions, so the backward keeps
    n / n_inner + n_inner residual-stream carries instead of n."""
    def body(h: torch.Tensor, rep: List[Block]) -> torch.Tensor:
        for layer in rep:
            h, _ = block_forward(layer.kind, layer, h, cfg, positions)
        return h

    def remat_body(h: torch.Tensor, rep: List[Block]) -> torch.Tensor:
        return checkpoint(body, h, rep, use_reentrant=False)

    def outer(h: torch.Tensor, reps: List[List[Block]]) -> torch.Tensor:
        for rep in reps:
            h = remat_body(h, rep)
        return h

    for reps in _groups(layers, cfg):
        n = len(reps)
        if not remat:
            for rep in reps:
                x = body(x, rep)
            continue
        n_inner = _split_factor(n) if n >= 9 else 1
        if n_inner == 1 and n >= 9:
            # prime depth: split off a tail so the main run still gets the
            # sqrt-remat treatment
            n_inner = _split_factor(n - 1) or 1
        n_main = (n // n_inner) * n_inner if n_inner > 1 else 0
        for o in range(0, n_main, n_inner):
            x = checkpoint(outer, x, reps[o:o + n_inner], use_reentrant=False)
        for rep in reps[n_main:]:
            x = remat_body(x, rep)
    return x


def run_stack_prefill(layers: Sequence[Block], x: torch.Tensor,
                      cfg: ModelConfig, positions: torch.Tensor, s_buf: int,
                      kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, Cache]:
    """Prefill forward that also returns the decode cache (one dict per
    layer)."""
    cache: Cache = []
    for layer in layers:
        x, c = block_forward(layer.kind, layer, x, cfg, positions, s_buf, kernels)
        cache.append(c)
    return x, cache


def run_stack_decode(layers: Sequence[Block], cache: Cache, x: torch.Tensor,
                     cfg: ModelConfig, pos: int,
                     kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, Cache]:
    """Single-token decode through all layers; each layer's cache dict is
    updated in place and the cache returned."""
    for layer, c in zip(layers, cache):
        x, _ = block_decode(layer.kind, layer, x, c, cfg, pos, kernels)
    return x, cache
