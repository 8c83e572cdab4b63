"""Layer primitives of the dense decoder (PyTorch).

Counterpart of ``repro/models/layers.py`` for the attention blocks:
parameters live in small ``nn.Module`` containers whose attribute names
are the JAX parameter keys (``wq.w``, ``ln1.scale``, ``embed.table``), and
linear weights keep the JAX layout ``(d_in, d_out)`` so weights carry
across without transposes.  The ``apply_*`` functions take those modules
and mirror the reference's numerics: fp32 norm math with ``1 + scale``,
weights cast to the input's dtype, the embedding scaled in the compute
dtype, fp32 logits.

``mha`` is the plain attention (the CPU path, the oracle of the attention
kernel, and what training runs under autograd, as the reference trains
with its jnp ``mha``); it never pads heads, which the reference does only
to make the head count divide a TPU mesh axis — zero heads change no
output.  ``attention_block`` is the training block: projections, rope,
``mha``, out-projection.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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

def raw_params(module: nn.Module, specs: Dict[str, Tuple[Tuple[int, ...], str, float]],
               dtype: torch.dtype, device) -> None:
    """Register plain parameters on ``module``, each ``name: (shape, init,
    scale)`` as the reference's ``ParamSpec`` (init ``normal`` draws normal
    x scale; ``zeros``, ``ones``); ``models.model.init_params`` reads the
    rules back from ``module.init_rules``."""
    module.init_rules = {}
    for name, (shape, init, scale) in specs.items():
        setattr(module, name, _param(shape, dtype, device))
        module.init_rules[name] = (init, scale)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.init_scale = 1.0 / math.sqrt(d_in)
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None


class Norm(nn.Module):
    def __init__(self, d: int, kind: str, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.kind = kind
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device) if kind != "rmsnorm" else None


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.init_scale = 1.0
        self.table = _param((vocab, d), dtype, device)


class Attention(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(dtype=dtype, device=device)
        self.wq = Linear(d, H * dh, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, K * dh, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, K * dh, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(H * dh, d, **kw)


class MLP(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.wi = Linear(d, f, **kw)
        self.wg = Linear(d, f, **kw) if cfg.mlp_act.endswith("_glu") else None
        self.wo = Linear(f, d, **kw)


# ---------------------------------------------------------------------------
# Norms / linear / positions
# ---------------------------------------------------------------------------

def apply_norm(p: Norm, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p.scale.float())
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + p.scale.float()) \
            + p.bias.float()
    return y.to(x.dtype)


def apply_linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p.w.to(x.dtype))
    if p.b is not None:
        y = y + p.b.to(x.dtype)
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
    restricts attention to the last ``window`` positions.  ``pad_heads`` is
    accepted for the reference's signature and ignored: its padded heads
    are zeros sliced off before the out-projection, so the result is the
    same without them.  Under autograd each q-chunk is checkpointed, as the
    reference's are, so only one chunk's fp32 scores live in the backward."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    q = q * _scalar(scale, q)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    k_pos = torch.arange(Sk, device=q.device)
    kf = k.float()

    def block(qc: torch.Tensor, q_pos: torch.Tensor, kf: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bqhd,bshd->bhqs", qc.float(), kf)
        s = _softcap(s, softcap)
        mask = torch.ones((qc.shape[1], Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        if k_len is not None:
            mask &= k_pos[None, :] < k_len
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype), v)

    if Sq > q_chunk and torch.is_grad_enabled():
        def chunk_fn(*args):
            return checkpoint(block, *args, use_reentrant=False)
    else:
        chunk_fn = block
    outs = [chunk_fn(q[:, c:c + q_chunk],
                     q_offset + torch.arange(c, min(c + q_chunk, Sq),
                                             device=q.device), kf, v)
            for c in range(0, Sq, q_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attention_block(p: Attention, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, window: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """Projection + attention (plain ``mha``) + out-projection: the
    training block.  Cross-attention (``encoder_out``) lands with the
    encoder-decoder slice."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = apply_linear(p.wq, x).reshape(B, S, H, dh)
    k = apply_linear(p.wk, x).reshape(B, S, K, dh)
    v = apply_linear(p.wv, x).reshape(B, S, K, dh)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = mha(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
              scale=cfg.query_scale, pad_heads=cfg.pad_heads)
    return apply_linear(p.wo, out.reshape(B, S, H * dh))


# ---------------------------------------------------------------------------
# Decode-step attention against a KV cache
# ---------------------------------------------------------------------------

def mha_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               k_len: int, softcap: float = 0.0,
               scale: Optional[float] = None) -> torch.Tensor:
    """Single-token grouped attention WITHOUT expanding KV heads.

    q: (B, 1, H, dh); k, v: (B, S_buf, K, dh); keys at positions >= k_len
    are masked."""
    B, _, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    qg = (q * _scalar(scale, q)).reshape(B, 1, K, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    s = _softcap(s, softcap)
    valid = torch.arange(Sk, device=q.device)[None, None, None, None, :] < k_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)


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
    q = apply_linear(p.wq, x).reshape(B, 1, H, dh)
    k_new = apply_linear(p.wk, x).reshape(B, 1, K, dh)
    v_new = apply_linear(p.wv, x).reshape(B, 1, K, dh)
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
    y = apply_linear(p.wo, out.reshape(B, 1, H * dh))
    return y, cache


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
    x = p.table[tokens].to(torch_dtype(cfg.compute_dtype))
    return x * _scalar(math.sqrt(cfg.d_model), x)


def apply_logits(p: Optional[Linear], embed_p: Embed, x: torch.Tensor,
                 cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = embed_p.table.to(x.dtype).T
    else:
        w = p.w.to(x.dtype)
    logits = torch.matmul(x, w)
    return _softcap(logits.float(), cfg.logit_softcap)

