"""Layer primitives of the dense decoder (PyTorch).

Counterpart of ``repro/models/layers.py`` for the attention blocks:
parameters live in small ``nn.Module`` containers whose attribute names
are the JAX parameter keys (``wq.w``, ``ln1.scale``, ``embed.table``), and
linear weights keep the JAX layout ``(d_in, d_out)`` so weights carry
across without transposes.  Each container's ``axes`` names every
parameter's logical sharding axes, as the reference's ``ParamSpec`` does
(resolved to mesh axes by ``repro_torch.launch.sharding``).  The
``apply_*`` functions take those modules and mirror the reference's
numerics: fp32 norm math with ``1 + scale``, weights cast to the input's
dtype, the embedding scaled in the compute dtype, fp32 logits.

``mha`` is the plain attention (the CPU path, the oracle of the attention
kernel, and what training runs under autograd, as the reference trains
with its jnp ``mha``); it pads heads to ``cfg.pad_heads`` only inside a
sharding context (``runtime.active()``), as the reference pads them so
that the head count divides the mesh's model axis — zero heads change no
output, so outside a context it computes the real heads alone.  Heads are
split out of a projection and merged back into one by ``split_heads`` and
``merge_heads`` (``runtime.unflatten`` / ``flatten``: a reshape, which
inside a context also places the heads by their logical axes).
``attention_block`` is the attention of a block without a cache:
projections, rope, the attention function it is given (``mha`` unless a
kernel's entry point is passed), out-projection; with ``encoder_out`` it is
the decoder's cross-attention, whose K and V come from the encoder.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..runtime import (active, constrain, flatten, gathered, on_shards,
                       placements, tp_lookup, tp_matmul, unflatten)
from ..runtime import pad as pad_zeros

NEG_INF = -1e30

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor of ``like``'s dtype: JAX rounds a
    weakly typed scalar to the array's dtype before the product."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Parameter containers (init: see models.model.init_params)
# ---------------------------------------------------------------------------

Axes = Tuple[Optional[str], ...]


def raw_params(module: nn.Module,
               specs: Dict[str, Tuple[Tuple[int, ...], Axes, str, float]],
               dtype: torch.dtype, device) -> None:
    """Register plain parameters on ``module``, each ``name: (shape, axes,
    init, scale)`` as the reference's ``ParamSpec`` (init ``normal`` draws
    normal x scale; ``zeros``, ``ones``); ``models.model.init_params``
    reads the rules back from ``module.init_rules``, the sharding the axes
    from ``module.axes``."""
    module.init_rules, module.axes = {}, {}
    for name, (shape, axes, init, scale) in specs.items():
        setattr(module, name, _param(shape, dtype, device))
        module.init_rules[name] = (init, scale)
        module.axes[name] = axes


def param(module: nn.Module, name: str) -> torch.Tensor:
    """Parameter ``name`` of a container as a product uses it
    (``runtime.gathered`` by its logical axes): the parameter itself
    outside a sharding context."""
    t = getattr(module, name)
    return gathered(t, *module.axes[name]) if active() else t


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, axes: Axes, *,
                 bias: bool = False, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.init_scale = 1.0 / math.sqrt(d_in)
        self.axes = {"w": tuple(axes), "b": (axes[1],)}
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None


class Norm(nn.Module):
    axes = {"scale": ("embed",), "bias": ("embed",)}

    def __init__(self, d: int, kind: str, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.kind = kind
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device) if kind != "rmsnorm" else None


class Embed(nn.Module):
    axes = {"table": ("vocab", "embed")}

    def __init__(self, vocab: int, d: int, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.init_scale = 1.0
        self.table = _param((vocab, d), dtype, device)


class Attention(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(dtype=dtype, device=device)
        self.wq = Linear(d, H * dh, ("embed", "q_proj"), bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, K * dh, ("embed", "kv_proj"), bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, K * dh, ("embed", "kv_proj"), bias=cfg.qkv_bias, **kw)
        self.wo = Linear(H * dh, d, ("q_proj", "embed"), **kw)


class MLP(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.wi = Linear(d, f, ("embed", "mlp"), **kw)
        self.wg = (Linear(d, f, ("embed", "mlp"), **kw)
                   if cfg.mlp_act.endswith("_glu") else None)
        self.wo = Linear(f, d, ("mlp", "embed"), **kw)


# ---------------------------------------------------------------------------
# Norms / linear / positions
# ---------------------------------------------------------------------------

def apply_norm(p: Norm, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    # a norm reduces over the features: whole on each device's rows
    xf = constrain(x, "batch").float()
    scale = param(p, "scale").float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale) \
            + param(p, "bias").float()
    return y.to(x.dtype)


def apply_linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = tp_matmul(x, param(p, "w").to(x.dtype))
    if p.b is not None:
        y = y + param(p, "b").to(x.dtype)
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal(seq: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(seq, d) fp32 absolute positions ``offset .. offset + seq - 1``:
    sin of the first half of the channels, cos of the second."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / max(half - 1, 1))
    ang = pos * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (plain; the kernel path is kernels.ops.attention)
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n * dh) -> (B, S, n, dh); inside a sharding context the
    heads take the ``model`` axis, or ``head_dim`` does where ``n`` does
    not divide it (``DEFAULT_RULES``' fallback)."""
    return unflatten(x, 2, (n, dh), "batch", None, "heads", "head_dim")


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, n, dh) -> (B, S, n * dh)."""
    return flatten(x, 2, 3)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, softcap: float = 0.0,
        q_offset: int = 0, k_len: Optional[int] = None,
        scale: Optional[float] = None, q_chunk: int = 512,
        pad_heads: int = 0) -> torch.Tensor:
    """Grouped-query attention with bounded-memory q-chunking.

    q: (B, Sq, H, dh); k, v: (B, Sk, K, dh) with H % K == 0.  ``q_offset``:
    absolute position of q[0]; ``k_len``: valid KV length; ``window`` > 0
    restricts attention to the last ``window`` positions.  Inside a
    sharding context the heads are zero-padded to ``pad_heads`` after the
    KV heads are expanded and sliced off the output, as the reference
    does; outside one ``pad_heads`` is ignored (the padded heads' outputs
    are zeros that are sliced off).  ``constrain`` pins q, k, v, the
    scores and each q-chunk (the reference's stacked chunks ``qs``) where
    the reference does.  Under autograd each q-chunk is checkpointed, as the
    reference's are, so only one chunk's fp32 scores live in the backward.
    With a causal ``window``, no ``k_len`` and several q-chunks, each chunk
    scores only the band of ``min(window + q_chunk, Sk)`` keys that can
    reach it, as the reference's does."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    q = q * _scalar(scale, q)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    H_real = H
    if active() and pad_heads > H:
        # padded on each device's batch rows, every head there
        pad = (0, 0, 0, pad_heads - H)
        q, k, v = (pad_zeros(constrain(t, "batch"), pad) for t in (q, k, v))
        H = pad_heads
    q = constrain(q, "batch", None, "heads")
    k = constrain(k, "batch", None, "heads")
    v = constrain(v, "batch", None, "heads")
    kf = k.float()
    # sliding-window KV band: a q-chunk sees keys in (q_start - window,
    # q_end) only, so its scores are q_chunk x (window + q_chunk), not
    # q_chunk x Sk (the reference's band; where it spans all Sk keys, no
    # narrowing)
    band = (window + q_chunk if window and causal and k_len is None
            and Sq > q_chunk and window + q_chunk < Sk else 0)

    def block(qc: torch.Tensor, q_pos: torch.Tensor, kf: torch.Tensor,
              v: torch.Tensor, start: int) -> torch.Tensor:
        if band:
            kf, v = kf.narrow(1, start, band), v.narrow(1, start, band)
        k_pos = torch.arange(start, start + kf.shape[1], device=qc.device)
        s = torch.matmul(qc.float().transpose(1, 2), kf.permute(0, 2, 3, 1))
        s = constrain(s, "batch", "heads")
        s = _softcap(s, softcap)
        mask = torch.ones((qc.shape[1], kf.shape[1]), dtype=torch.bool, device=qc.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        if k_len is not None:
            mask &= k_pos[None, :] < k_len
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p.to(v.dtype), v.transpose(1, 2)).transpose(1, 2)

    # per batch row and head: on the local shards inside a context
    block = on_shards(block, placements(q))
    if Sq > q_chunk and torch.is_grad_enabled():
        def chunk_fn(*args):
            return checkpoint(block, *args, use_reentrant=False)
    else:
        chunk_fn = block
    # each band ends at its chunk's padded end, as the reference's does
    starts = [min(max(q_offset + c + q_chunk - band, 0), Sk - band) if band else 0
              for c in range(0, Sq, q_chunk)]
    outs = [chunk_fn(constrain(q[:, c:c + q_chunk], "batch", None, "heads"),
                     q_offset + torch.arange(c, min(c + q_chunk, Sq),
                                             device=q.device), kf, v, start)
            for c, start in zip(range(0, Sq, q_chunk), starts)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out if H == H_real else out[:, :, :H_real]


def attention_block(p: Attention, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, window: int = 0,
                    encoder_out: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    attention: Callable[..., torch.Tensor] = mha,
                    return_kv: bool = False):
    """Projection + (optionally cross-) attention + out-projection.

    With ``encoder_out`` (B, Se, d) K and V are projected from it, with no
    rope and no causal mask: the decoder's cross-attention.  ``attention``
    takes q (B, S, H, dh) and k, v (B, Sk, K, dh), each contiguous as the
    kernel's wrapper demands: ``mha`` (training) or ``ops.attention`` (a
    serving forward), each also given ``cfg.pad_heads``.  With
    ``return_kv`` also returns k and v, which a prefill keeps as the cross
    cache."""
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_src = x if encoder_out is None else encoder_out
    q = split_heads(apply_linear(p.wq, x), H, dh)
    k = split_heads(apply_linear(p.wk, kv_src), K, dh)
    v = split_heads(apply_linear(p.wv, kv_src), K, dh)
    if cfg.use_rope and encoder_out is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=causal and encoder_out is None,
                    window=window, softcap=cfg.attn_softcap,
                    scale=cfg.query_scale, pad_heads=cfg.pad_heads)
    y = apply_linear(p.wo, merge_heads(out))
    return (y, k, v) if return_kv else y


# ---------------------------------------------------------------------------
# Decode-step attention against a KV cache
# ---------------------------------------------------------------------------

def mha_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               k_len: int, softcap: float = 0.0,
               scale: Optional[float] = None) -> torch.Tensor:
    """Single-token grouped attention WITHOUT expanding KV heads.

    q: (B, 1, H, dh); k, v: (B, S_buf, K, dh); keys at positions >= k_len
    are masked.  The G query heads of a KV head are the rows of one
    product with its keys (batched over B and K)."""
    B, _, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    qg = unflatten(q * _scalar(scale, q), 2, (K, G),
                   "batch", None, "kv_heads", None, "head_dim")[:, 0]

    def core(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        s = torch.matmul(qg.float(), k.float().permute(0, 2, 3, 1))  # (B, K, G, Sk)
        s = _softcap(s, softcap)
        valid = torch.arange(Sk, device=q.device) < k_len
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p, v.float().transpose(1, 2))            # (B, K, G, dh)

    # per batch row and KV head on the local shards, where the cache is
    # split by those alone (not by keys or head_dim, whose products need
    # their partial sums reduced)
    pl = placements(qg)
    if pl is not None and not (placements(k) == placements(v) == _cache_like(pl)):
        pl = None
    out = on_shards(core, pl)(qg, k, v)
    return flatten(out, 1, 2)[:, None].to(q.dtype)


def _cache_like(qg_placements):
    """The placements of a (B, S, K, dh) cache that split it as (B, K, G,
    dh) grouped queries with ``qg_placements`` are split, where those
    shard batch rows or KV heads only; None otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in qg_placements:
        if isinstance(p, Shard) and p.dim in (0, 1):
            out.append(Shard(0 if p.dim == 0 else 2))
        elif isinstance(p, Replicate):
            out.append(p)
        else:
            return None
    return tuple(out)


def attention_decode(p: Attention, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg, *, pos: int,
                     window: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention against the cache {"k","v"}: (B, S_buf, K, dh).

    For windowed layers the cache is a ring buffer and the write slot is
    ``pos % S_buf``; otherwise it is a full-length buffer written at slot
    ``pos``.  The new key/value are written into the cache in place (the
    reference returns an updated copy)."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per request, got {S}")
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = split_heads(apply_linear(p.wq, x), H, dh)
    k_new = split_heads(apply_linear(p.wk, x), K, dh)
    v_new = split_heads(apply_linear(p.wv, x), K, dh)
    if cfg.use_rope:
        positions = torch.full((B, 1), float(pos), device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k_new = rope(k_new, positions, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    s_buf = kc.shape[1]
    slot = pos % s_buf if window else pos
    kc[:, slot] = k_new[:, 0].to(kc.dtype)
    vc[:, slot] = v_new[:, 0].to(vc.dtype)
    k_len = min(pos + 1, s_buf) if window else pos + 1
    out = mha_decode(q, kc, vc, k_len=k_len, softcap=cfg.attn_softcap,
                     scale=cfg.query_scale)
    y = apply_linear(p.wo, merge_heads(out))
    return y, cache


def cross_attention_decode(p: Attention, x: torch.Tensor,
                           cache: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    """One token's cross-attention against the prefill's cross cache
    {"cross_k", "cross_v"}: (B, Se, K, dh), all ``Se`` keys valid."""
    q = split_heads(apply_linear(p.wq, x), cfg.n_heads, cfg.d_head)
    k, v = cache["cross_k"], cache["cross_v"]
    out = mha_decode(q, k, v, k_len=k.shape[1], scale=cfg.query_scale)
    return apply_linear(p.wo, merge_heads(out))


# ---------------------------------------------------------------------------
# MLP / embedding / logits
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op: x * sigmoid(x), each rounded to x's dtype
    (torch's fused silu rounds bf16 once and differs in the last bit)."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) op by op in x's dtype, so that
    bf16 rounds where the reference rounds."""
    inner = _scalar(math.sqrt(2.0 / math.pi), x) * (x + _scalar(0.044715, x) * (x * x * x))
    return x * (_scalar(0.5, x) * (1.0 + torch.tanh(inner)))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind.startswith("silu"):
        return silu(x)
    if kind.startswith("gelu"):
        return gelu(x)
    if kind == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind}")


def apply_mlp(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    h = _act(apply_linear(p.wi, x), cfg.mlp_act)
    if cfg.mlp_act.endswith("_glu"):
        h = h * apply_linear(p.wg, x)
    return apply_linear(p.wo, h)


def apply_embed(p: Embed, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = tp_lookup(param(p, "table"), tokens).to(torch_dtype(cfg.compute_dtype))
    return x * _scalar(math.sqrt(cfg.d_model), x)


def apply_logits(p: Optional[Linear], embed_p: Embed, x: torch.Tensor,
                 cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = param(embed_p, "table").to(x.dtype).T
    else:
        w = param(p, "w").to(x.dtype)
    logits = tp_matmul(x, w)
    return _softcap(logits.float(), cfg.logit_softcap)

