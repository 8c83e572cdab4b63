"""Transformer stack of the port: the ``"global"``, ``"local"``,
``"moe_global"``, ``"moe_local"``, ``"rec"`` and ``"rwkv"`` blocks, and the
single-mixer layers of a hybrid stack (``models.mamba2.HybridConfig``:
``"mamba2"``, ``"attn"``, ``"mlp"``, each ``x + mixer(ln1(x))``).

Counterpart of ``repro/models/transformer.py``: the training forward
(``run_stack``, under autograd with per-layer rematerialization), prefill
with decode-cache collection (``run_stack_prefill``) and single-token
decode (``run_stack_decode``).  The reference scans over layers stacked on
a leading axis; here each layer is one ``Block`` in an ``nn.ModuleList``
and the scan is a loop over the same groups (``group_meta``).  Attention
blocks take the MoE FFN (``models.moe``) in place of the MLP for the
``moe_*`` kinds, attend within ``cfg.window`` for the ``*local`` kinds, and
add gemma2's sandwich norms (``post1`` after attention, ``post2`` after
the MLP or MoE) when ``cfg.post_norm`` is set.  For an encoder-decoder
(``cfg.is_encdec``: whisper) the decoder's blocks also hold the
cross-attention ``cross`` and its norm ``ln_cross``, run after ``post1``
against the encoder's output; the encoder's blocks are plain
``"global"`` blocks run without a causal mask.

Every kernel of a serving block comes from a :class:`Kernels` bundle:
``KERNELS`` (``kernels.ops``: the Hopper kernels on the card, their plain
versions on the CPU) on the serving path, ``PLAIN`` (the models' own plain
forms) for comparisons on any device, ``DRYRUN`` (the forms the reference's
compiled steps run: ``mha``, the chunked WKV6 for a sequence and the
sequential one for a token, the associative RG-LRU scan) for the sharded
steps that ``launch.dryrun`` counts on the ``meta`` device, where
``kernels.ops`` raises.  The serving path's prefill and its
encoder take the bundle's attention for every attention (self, cross and
the encoder's); decode attends with the plain ``mha_decode``.  A Mamba-2
layer's prefill runs the chunked SSD scan in plain torch; its decode step
hands all between its projections to the bundle's ``ssm_state_update``
(K4 on the card).  Two kinds of state then live in one cache: K/V
buffers in the attention layers, a conv state and an fp32 SSM state in
the Mamba-2 layers (an MLP layer's dict is empty).  Training
takes no bundle: it runs the plain forms the reference trains with
(``mha``, ``wkv6_chunked``, the associative ``rglru_scan``), since the
kernels have no backward.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import ssm_state_update_ref
from ..runtime import constrain, on_shards, placements, scope
from .config import ModelConfig
from .layers import (MLP, Attention, Norm, apply_linear, apply_mlp,
                     apply_norm, attention_block, attention_decode,
                     cross_attention_decode, merge_heads, mha, rope,
                     split_heads, torch_dtype)
from .mamba2 import (MIXER_KINDS, Mamba2, apply_mamba2, mamba2_cache_shape,
                     mamba2_decode)
from .moe import MoE, apply_moe
from .rglru import (RGLRU, apply_rglru, init_rglru_state, rglru_decode,
                    rglru_scan)
from .rwkv6 import (TimeMix, apply_channel_mix, apply_time_mix,
                    init_rwkv6_state, wkv6_plain, wkv6_sequential)

PORTED_KINDS = ("global", "local", "moe_global", "moe_local", "rec", "rwkv",
                *MIXER_KINDS)

Cache = List[Dict[str, torch.Tensor]]   # one dict of state tensors per layer
AttentionFn = Callable[..., torch.Tensor]


class Kernels(NamedTuple):
    """The functions a block's kernels stand for: causal GQA attention on
    (B, S, H, dh) / (B, S, K, dh); the WKV6 recurrence ``(r, k, v, logw, u,
    s0) -> (y, s_final)``; the RG-LRU scan ``(a, b, h0) -> h``; a Mamba-2
    layer's decode step between its projections (``kernels.ops.
    ssm_state_update``'s arguments; the conv and SSM states in place;
    ``kernels.ops.ssm_state_update`` unless given)."""
    attention: AttentionFn
    wkv6: Callable
    rglru_scan: Callable
    ssm_state_update: Callable = ops.ssm_state_update


KERNELS = Kernels(ops.attention, ops.wkv6, ops.rglru_scan, ops.ssm_state_update)
PLAIN = Kernels(mha, wkv6_sequential, rglru_scan, ssm_state_update_ref)
# the forms the reference's compiled steps run (its models reach no Pallas
# kernel): what a step counted on the meta device, the dry-run's, runs
DRYRUN = Kernels(mha, wkv6_plain, rglru_scan, ssm_state_update_ref)


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind.endswith("local") else 0


def group_meta(cfg: ModelConfig, n_layers: Optional[int] = None
               ) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
    """((unit kinds, n_repeats), ...) covering ``n_layers`` (default
    cfg.n_layers) in order — the reference's stacking, used to map its
    keypaths onto layers."""
    unit = cfg.block_pattern
    n_full, leftover = divmod(cfg.n_layers if n_layers is None else n_layers,
                              len(unit))
    groups: List[Tuple[Tuple[str, ...], int]] = []
    if n_full:
        groups.append((unit, n_full))
    if leftover:
        groups.append((unit[:leftover], 1))
    return tuple(groups)


class Block(nn.Module):
    """Pre-norm block: attention + MLP (``"global"``, ``"local"``),
    attention + MoE (``"moe_global"``, ``"moe_local"``), RG-LRU + MLP
    (``"rec"``), RWKV6 time-mix + channel-mix (``"rwkv"``), or one mixer on
    ``ln1`` alone: ``mamba`` (``"mamba2"``), ``attn`` (``"attn"``), ``mlp``
    (``"mlp"``).  With ``cfg.post_norm`` every block holds ``post1`` and
    ``post2``, as the reference's ``block_spec`` does; the attention blocks
    apply them.  With ``cross`` an attention block also holds the
    cross-attention ``cross`` and ``ln_cross`` (an encoder-decoder's decoder
    blocks).  On the card unless ``device`` is ``"cpu"``."""

    def __init__(self, cfg: ModelConfig, kind: str,
                 device: Union[str, torch.device] = "cuda", cross: bool = False):
        super().__init__()
        check_kind(kind)
        device = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.kind = kind
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        if kind in MIXER_KINDS:
            if kind == "mamba2":
                self.mamba = Mamba2(cfg, dtype, device)
            elif kind == "attn":
                self.attn = Attention(cfg, dtype, device)
            else:
                self.mlp = MLP(cfg, dtype, device)
            return
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        if cfg.post_norm:
            self.post1 = Norm(cfg.d_model, cfg.norm, dtype, device)
            self.post2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        if kind == "rwkv":
            self.tm = TimeMix(cfg, dtype, device)
            return
        if kind == "rec":
            self.rec = RGLRU(cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
            if cross:
                self.cross = Attention(cfg, dtype, device)
                self.ln_cross = Norm(cfg.d_model, cfg.norm, dtype, device)
        if kind.startswith("moe"):
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)


# ---------------------------------------------------------------------------
# Forward blocks (training / prefill)
# ---------------------------------------------------------------------------

def block_forward(kind: str, p: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor,
                  encoder_out: Optional[torch.Tensor] = None,
                  causal: bool = True, collect_cache: Optional[int] = None,
                  kernels: Optional[Kernels] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One block; returns (x, its decode cache or None).  ``encoder_out``:
    the encoder's output, which a block holding ``cross`` attends to;
    ``causal``: False for the encoder's blocks.  ``collect_cache``: the
    prefill's KV buffer length (attention caches hold that many positions,
    or a ring of ``cfg.window``; a cross-attention block also keeps its
    encoder K/V), through ``kernels``.  Without ``collect_cache`` the
    block runs without a cache: through ``kernels``' attention if a bundle
    is given (the encoder on the serving path), else the plain forms under
    autograd (training)."""
    check_kind(kind)
    if collect_cache is None:
        attention = mha if kernels is None else kernels.attention
        return _forward_block(kind, p, x, cfg, positions, encoder_out, causal,
                              attention), None
    if kernels is None:
        raise ValueError("a prefill (collect_cache) runs through a Kernels bundle")
    h_in = apply_norm(p.ln1, x, cfg.norm)
    if kind == "mamba2":
        h, cache = apply_mamba2(p.mamba, h_in, cfg, return_state=True)
        return x + h, cache
    if kind == "mlp":
        return x + apply_mlp(p.mlp, h_in, cfg), {}
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
        return _mlp_residual(p, x + h, cfg), cache
    h, cache = _attention_with_cache(p.attn, h_in, cfg, positions,
                                     _window(cfg, kind), collect_cache,
                                     kernels.attention)
    if kind == "attn":
        return x + h, cache

    def cross(hc: torch.Tensor) -> torch.Tensor:
        y, cache["cross_k"], cache["cross_v"] = attention_block(
            p.cross, hc, cfg, positions=positions, encoder_out=encoder_out,
            attention=kernels.attention, return_kv=True)
        return y

    return _attention_residuals(kind, p, x, h, cfg, cross), cache


def _mlp_residual(p: Block, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg.norm), cfg)


def _maybe_post(p: Block, h: torch.Tensor, cfg: ModelConfig, name: str) -> torch.Tensor:
    return apply_norm(getattr(p, name), h, cfg.norm) if cfg.post_norm else h


def _attention_residuals(kind: str, p: Block, x: torch.Tensor, h: torch.Tensor,
                         cfg: ModelConfig,
                         cross: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """An attention block from its attention output ``h`` on: the residual
    add (through ``post1``), the cross-attention ``cross`` on ``ln_cross``
    where the block holds one, then the MLP or MoE on ``ln2`` (through
    ``post2``)."""
    x = x + _maybe_post(p, h, cfg, "post1")
    if hasattr(p, "cross"):
        x = x + cross(apply_norm(p.ln_cross, x, cfg.norm))
    h2_in = apply_norm(p.ln2, x, cfg.norm)
    if kind.startswith("moe"):
        h2 = apply_moe(p.moe, h2_in, cfg)
    else:
        h2 = apply_mlp(p.mlp, h2_in, cfg)
    return x + _maybe_post(p, h2, cfg, "post2")


def _forward_block(kind: str, p: Block, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, encoder_out: Optional[torch.Tensor],
                   causal: bool, attention: AttentionFn) -> torch.Tensor:
    """The reference's ``collect_cache=None`` branch, with its plain forms
    (chunked WKV6 for S > 1, sequential for one token; the associative
    RG-LRU scan) and ``attention`` for every attention: jnp-style ``mha``
    in training, a kernel for the encoder on the serving path."""
    h_in = apply_norm(p.ln1, x, cfg.norm)
    if kind == "mamba2":
        return x + apply_mamba2(p.mamba, h_in, cfg)
    if kind == "mlp":
        return x + apply_mlp(p.mlp, h_in, cfg)
    if kind == "rwkv":
        x = x + apply_time_mix(p.tm, h_in, cfg, wkv=wkv6_plain)
        return x + apply_channel_mix(p.tm, apply_norm(p.ln2, x, cfg.norm), cfg)
    if kind == "rec":
        return _mlp_residual(p, x + apply_rglru(p.rec, h_in, cfg, scan=rglru_scan), cfg)
    h = attention_block(p.attn, h_in, cfg, positions=positions,
                        window=_window(cfg, kind), causal=causal,
                        attention=attention)
    if kind == "attn":
        return x + h

    def cross(hc: torch.Tensor) -> torch.Tensor:
        return attention_block(p.cross, hc, cfg, positions=positions,
                               encoder_out=encoder_out, attention=attention)

    return _attention_residuals(kind, p, x, h, cfg, cross)


def _attention_with_cache(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, window: int, s_buf: int,
                          attention: AttentionFn):
    """Prefill attention that also emits the KV cache buffer."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = split_heads(apply_linear(p.wq, x), H, dh)
    k = split_heads(apply_linear(p.wk, x), K, dh)
    v = split_heads(apply_linear(p.wv, x), K, dh)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=True, window=window,
                    softcap=cfg.attn_softcap, scale=cfg.query_scale,
                    pad_heads=cfg.pad_heads)
    y = apply_linear(p.wo, merge_heads(out))

    def buffers(k: torch.Tensor, v: torch.Tensor):
        B = k.shape[0]
        if window and window < s_buf:
            # ring buffer holding the last `window` positions at slot p % window
            lo = max(S - window, 0)
            slots = torch.arange(lo, S, device=k.device) % window
            kc = k.new_zeros((B, window) + tuple(k.shape[2:]))
            vc = v.new_zeros((B, window) + tuple(v.shape[2:]))
            kc[:, slots] = k[:, lo:]
            vc[:, slots] = v[:, lo:]
        else:
            kc = k.new_zeros((B, s_buf) + tuple(k.shape[2:]))
            vc = v.new_zeros((B, s_buf) + tuple(v.shape[2:]))
            kc[:, :S] = k
            vc[:, :S] = v
        return kc, vc

    # the cache is written position by position, per batch row and head:
    # on each device's shards inside a sharding context
    kc, vc = on_shards(buffers, placements(k), placements(v))(k, v)
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
    replaced; a cross-attention block reads its encoder K/V; a Mamba-2
    layer's conv state rolled and its SSM state updated)."""
    check_kind(kind)
    h_in = apply_norm(p.ln1, x, cfg.norm)
    if kind == "mamba2":
        return x + mamba2_decode(p.mamba, h_in, cfg, cache, kernels.ssm_state_update), cache
    if kind == "mlp":
        return x + apply_mlp(p.mlp, h_in, cfg), cache
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
        return _mlp_residual(p, x + h, cfg), cache
    h, cache = attention_decode(p.attn, h_in, cache, cfg, pos=pos,
                                window=_window(cfg, kind))
    if kind == "attn":
        return x + h, cache

    def cross(hc: torch.Tensor) -> torch.Tensor:
        return cross_attention_decode(p.cross, hc, cache, cfg)

    return _attention_residuals(kind, p, x, h, cfg, cross), cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def layer_cache_shape(cfg: ModelConfig, kind: str, batch: int, s_buf: int,
                      cross: bool = False
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each tensor of one layer's decode cache; with
    ``cross`` an attention layer also keeps its cross-attention's encoder
    K/V, ``(batch, cfg.encoder_seq, K, dh)`` each.  A Mamba-2 layer keeps
    its conv state ``(batch, conv_dim, taps - 1)`` in the compute dtype and
    its SSM state ``(batch, H, P, N)`` in fp32; an MLP layer keeps none."""
    check_kind(kind)
    f32 = torch.float32
    if kind == "mamba2":
        return mamba2_cache_shape(cfg, batch, torch_dtype(cfg.compute_dtype))
    if kind == "mlp":
        return {}
    if kind == "rwkv":
        return {name: (tuple(t.shape), t.dtype)
                for name, t in init_rwkv6_state(cfg, batch, "meta").items()}
    if kind == "rec":
        return {name: (tuple(t.shape), f32)
                for name, t in init_rglru_state(cfg, batch, "meta").items()}
    window = _window(cfg, kind)
    n = min(window, s_buf) if window else s_buf
    cdt = torch_dtype(cfg.compute_dtype)
    spec = ((batch, n, cfg.n_kv_heads, cfg.d_head), cdt)
    out = {"k": spec, "v": spec}
    if cross:
        enc = ((batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.d_head), cdt)
        out.update(cross_k=enc, cross_v=enc)
    return out


def init_cache(cfg: ModelConfig, batch: int, s_buf: int,
               device: Union[str, torch.device] = "cuda") -> Cache:
    """Zeroed decode cache, one dict per layer, on ``device`` (the card
    unless the caller asks for ``"cpu"``; ``device.resolve_device``
    raises where there is no card)."""
    device = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in
             layer_cache_shape(cfg, kind, batch, s_buf, cfg.is_encdec).items()}
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
    """Per group of ``group_meta`` over ``layers`` (the decoder's, or the
    encoder's, which the reference stacks the same way): its repetitions,
    each the list of the unit's layers."""
    start = 0
    for unit, n in group_meta(cfg, len(layers)):
        u = len(unit)
        yield [list(layers[start + r * u:start + (r + 1) * u]) for r in range(n)]
        start += n * u


def run_stack(layers: Sequence[Block], x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, encoder_out: Optional[torch.Tensor] = None,
              causal: bool = True, remat: bool = True,
              kernels: Optional[Kernels] = None,
              name: str = "layers") -> torch.Tensor:
    """Forward through all groups without a cache: training, under
    autograd, or, given ``kernels``, the encoder of the serving path (no
    remat: it runs under ``no_grad``).  ``causal`` is False for the
    encoder; ``encoder_out`` feeds the decoder's cross-attention.  Layer
    i runs under the cost scope ``<name>.<i>``, its recompute too.

    With ``remat`` each repetition of a group's unit is checkpointed (the
    reference's ``nothing_saveable`` scan body: only its input is kept, the
    rest is recomputed in the backward).  Groups of n >= 9 repetitions take
    the reference's two-level split: checkpointed runs of n_inner
    repetitions over checkpointed repetitions, so the backward keeps
    n / n_inner + n_inner residual-stream carries instead of n."""
    index = {id(layer): i for i, layer in enumerate(layers)}

    def body(h: torch.Tensor, rep: List[Block]) -> torch.Tensor:
        for layer in rep:
            with scope(f"{name}.{index[id(layer)]}"):
                h, _ = block_forward(layer.kind, layer, h, cfg, positions,
                                     encoder_out, causal, kernels=kernels)
                h = constrain(h, "batch")
        return h

    def remat_body(h: torch.Tensor, rep: List[Block]) -> torch.Tensor:
        return checkpoint(body, h, rep, use_reentrant=False)

    def outer(h: torch.Tensor, reps: List[List[Block]]) -> torch.Tensor:
        for rep in reps:
            h = remat_body(h, rep)
        return h

    if kernels is not None:
        return body(x, list(layers))
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
                      kernels: Kernels = KERNELS,
                      encoder_out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """Prefill forward that also returns the decode cache (one dict per
    layer); ``encoder_out`` feeds the decoder's cross-attention."""
    cache: Cache = []
    for layer in layers:
        x, c = block_forward(layer.kind, layer, x, cfg, positions, encoder_out,
                             collect_cache=s_buf, kernels=kernels)
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
