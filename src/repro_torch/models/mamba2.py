"""Mamba-2 mixer and the hybrid stack's config (Nemotron-H), PyTorch.

The port's first layer with no counterpart in the JAX package.  Mamba-2
(Dao and Gu, arXiv:2405.21060) as Nemotron-H runs it (arXiv:2504.03624),
with d_inner = H x P channels in H heads of P, and B, C in G groups of N
(head h reads group h // (H / G)):
    [z, xBC, dt] = x W_in
    xBC = SiLU(causal_conv1d(xBC) + b)          depthwise, ``conv_width`` taps
    [x, B, C] = split(xBC);  dt = softplus(dt + dt_bias);  A = -exp(A_log)
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t (outer) B_t;  y_t = S_t C_t + D x_t
    y = RMSNorm over G groups of (y * SiLU(z)), times 1 + scale
    out = y W_out
The state S of a head is (P, N), kept in fp32.

The prefill (``apply_mamba2``) runs the chunked SSD form: within each chunk
of ``ssm_chunk`` steps the products C_t . B_s under the segment-sum decay
mask exp(a_t - a_s) (a the running sum of dt A), then the state carried
from chunk to chunk, all in fp32 (the decays are exponentials of long
sums); it works on pieces of whole batch rows of at most ``PIECE_TOKENS``
tokens, so its fp32 intermediates stay small beside a batch's.  The decode
step (``mamba2_decode``) hands all between its two projections to the
``ssm_update`` it is given: ``kernels.ops.ssm_state_update`` on the
serving path (K4 on the card, one call for the conv step, the state update
and the gated norm; its plain form on the CPU).

The prefill's conv and SSD run under the cost scopes ``mamba2.conv`` and
``mamba2.ssd``, the decode step's K4 under ``mamba2.state_update``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ref import gated_rms_norm_ref
from ..runtime import pad, scope
from .config import ModelConfig
from .layers import Linear, Norm, apply_linear, param, raw_params

PIECE_TOKENS = 8192     # tokens of whole batch rows per piece of a prefill

UpdateFn = Callable[..., torch.Tensor]
MIXER_KINDS = ("mamba2", "attn", "mlp")


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A stack of single-mixer layers, each ``x + mixer(norm(x))``
    (Nemotron-H, arXiv:2504.03624), the kinds in ``block_pattern``:
    ``"mamba2"`` (the Mamba-2 mixer, :class:`Mamba2`), ``"attn"`` (GQA
    attention alone, causal, no bias), ``"mlp"`` (the MLP alone).  The
    attention takes rope where ``use_rope`` is set and no position
    embedding otherwise: a hybrid stack never adds sinusoidal positions
    (``models.model.sinusoidal_positions``).
    The Mamba-2 sizes: ``ssm_heads`` heads of ``ssm_head_dim`` channels,
    B and C in ``ssm_groups`` groups of ``ssm_state``, the conv of
    ``conv_width`` taps, the prefill's chunks of ``ssm_chunk`` steps.  A
    subclass, so that the ten configurations of the JAX package's registry
    keep their fields (and ``models/config.py`` stays the reference's
    copy)."""
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_state: int = 128
    ssm_chunk: int = 128

    def __post_init__(self):
        for kind in self.block_pattern:
            if kind not in MIXER_KINDS:
                raise ValueError(f"unknown block kind {kind!r} of a hybrid stack")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.ssm_heads % self.ssm_groups:
            raise ValueError("ssm_heads must be divisible by ssm_groups")

    @property
    def ssm_sizes(self) -> Tuple[int, int, int, int, int, int]:
        """(H, P, G, N, d_inner, conv_dim) of the Mamba-2 mixer: the conv
        runs over x, B and C, d_inner + 2 G N channels."""
        H, P, G, N = self.ssm_heads, self.ssm_head_dim, self.ssm_groups, self.ssm_state
        return H, P, G, N, H * P, H * P + 2 * G * N

    def layer_params(self, kind: str) -> int:
        """Parameters of one layer but its norm: the Mamba-2 mixer's in-
        and out-projections, conv taps and bias, dt bias, A, D and gated
        norm; the attention's four projections; the MLP's two or three."""
        d, dh = self.d_model, self.d_head
        if kind == "mamba2":
            H, _, _, _, di, conv_dim = self.ssm_sizes
            return d * (di + conv_dim + H) + di * d \
                + (self.conv_width + 1) * conv_dim + 3 * H + di
        if kind == "attn":
            return 2 * d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
        return d * self.d_ff * (3 if self.mlp_act.endswith("_glu") else 2)

    def active_params(self) -> int:
        """Every parameter: the embedding (and head), each layer's and its
        norm, the final norm; a hybrid stack has no experts."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        layers = sum(self.layer_params(kind) + self.d_model for kind in self.layer_kinds)
        return emb + layers + self.d_model

    def total_params(self) -> int:
        return self.active_params()


class Mamba2(nn.Module):
    """The mixer's parameters: ``in_proj`` (d, d_inner + conv_dim + H) in
    the order z, xBC, dt; ``conv_w`` (conv_dim, taps) and ``conv_b``;
    ``dt_bias``, ``A_log``, ``D`` (H,); the gated norm ``norm`` (d_inner);
    ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: HybridConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        H, _, _, _, di, conv_dim = cfg.ssm_sizes
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Linear(cfg.d_model, di + conv_dim + H, ("embed", None), **kw)
        raw_params(self, {
            "conv_w": ((conv_dim, cfg.conv_width), (None, None), "normal",
                       1.0 / math.sqrt(cfg.conv_width)),
            "conv_b": ((conv_dim,), (None,), "zeros", 0.0),
            "dt_bias": ((H,), (None,), "zeros", 0.0),
            "A_log": ((H,), (None,), "normal", 1.0),
            "D": ((H,), (None,), "ones", 0.0),
        }, dtype, device)
        self.norm = Norm(di, "rmsnorm", dtype, device)
        self.out_proj = Linear(di, cfg.d_model, (None, "embed"), **kw)


def _conv(p: Mamba2, ext: torch.Tensor) -> torch.Tensor:
    """SiLU of the depthwise causal conv, fp32: ext (B, T + taps - 1,
    conv_dim), the taps - 1 inputs before the first output leading ->
    (B, T, conv_dim)."""
    w = param(p, "conv_w").float()                  # (conv_dim, taps)
    taps = w.shape[1]
    T = ext.shape[1] - taps + 1
    xf = ext.float()
    out = xf[:, 0:T] * w[:, 0]
    for t in range(1, taps):                        # taps is tiny (4): unrolled
        out = out + xf[:, t:t + T] * w[:, t]
    return F.silu(out + param(p, "conv_b").float())


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan from a zero state, fp32.  x (b, S, H, P), dt (b, S, H),
    A (H,), B and C (b, S, G, N) -> (y without the D term (b, S, H, P),
    the final state (b, H, P, N)).

    Per chunk of ``chunk`` steps, with a_t the running sum of dt A from
    the chunk's start: y_t = sum_{s <= t in the chunk} exp(a_t - a_s)
    (C_t . B_s) dt_s x_s + exp(a_t) C_t . S_in, and the state leaving it
    S_out = exp(a_end) S_in + sum_s exp(a_end - a_s) dt_s x_s (outer) B_s.
    Heads are taken group by group, so B and C are never repeated."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hg = H // G
    state = x.new_zeros((b, G, hg, P, N))
    xdt = (x * dt[..., None]).view(b, S, G, hg, P)
    dtA = (dt * A).view(b, S, G, hg)
    ys = []
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        a = torch.cumsum(dtA[:, c0:c0 + L], dim=1)                   # (b, L, G, hg)
        Bc, Cc, xc = B[:, c0:c0 + L], C[:, c0:c0 + L], xdt[:, c0:c0 + L]
        at = a.permute(0, 2, 3, 1)                                  # (b, G, hg, L)
        seg = at[..., :, None] - at[..., None, :]                   # a_t - a_s
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))  # (b, G, hg, L, L)
        cb = torch.einsum("btgn,bsgn->bgts", Cc, Bc)                 # (b, G, L, L)
        y = torch.einsum("bgjts,bsgjp->btgjp", decay * cb[:, :, None], xc)
        y = y + torch.einsum("btgn,bgjpn->btgjp", Cc, state) * torch.exp(a)[..., None]
        w = torch.exp(a[:, -1:] - a)                                # (b, L, G, hg)
        state = state * torch.exp(a[:, -1])[..., None, None] \
            + torch.einsum("bsgjp,bsgn->bgjpn", xc * w[..., None], Bc)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.reshape(b, S, H, P), state.reshape(b, H, P, N)


def apply_mamba2(p: Mamba2, x: torch.Tensor, cfg: HybridConfig,
                 return_state: bool = False):
    """The mixer over a sequence from a zero state.  x: (B, S, d) ->
    (B, S, d), with ``return_state`` also the decode cache {"conv": the
    last taps - 1 inputs of the conv (B, conv_dim, taps - 1) in x's dtype,
    "ssm": the final state (B, H, P, N) fp32}."""
    Bt, S, _ = x.shape
    H, P, G, N, di, conv_dim = cfg.ssm_sizes
    taps = cfg.conv_width
    zxbcdt = apply_linear(p.in_proj, x)
    A = -torch.exp(param(p, "A_log").float())
    Df = param(p, "D").float()
    out = x.new_empty((Bt, S, di))
    if return_state:
        cache = {"conv": x.new_empty((Bt, conv_dim, taps - 1)),
                 "ssm": x.new_empty((Bt, H, P, N), dtype=torch.float32)}
    rows = max(1, PIECE_TOKENS // S)
    for r0 in range(0, Bt, rows):
        z, xbc, dt = zxbcdt[r0:r0 + rows].split([di, conv_dim, H], dim=-1)
        b = z.shape[0]
        with scope("mamba2.conv"):
            ext = pad(xbc, (0, 0, taps - 1, 0))     # zeros before the prompt
            u = _conv(p, ext)
        xs, Bm, Cm = u.split([di, G * N, G * N], dim=-1)
        xs = xs.view(b, S, H, P)
        dt = F.softplus(dt.float() + param(p, "dt_bias").float())
        with scope("mamba2.ssd"):
            y, s_final = ssd_chunked(xs, dt, A, Bm.view(b, S, G, N), Cm.view(b, S, G, N),
                                     cfg.ssm_chunk)
        y = y + Df[:, None] * xs
        out[r0:r0 + b] = gated_rms_norm_ref(y.reshape(b, S, di), z, param(p.norm, "scale"), G)
        if return_state:
            cache["ssm"][r0:r0 + b] = s_final
            cache["conv"][r0:r0 + b] = ext[:, S:].transpose(1, 2)
    y = apply_linear(p.out_proj, out)
    return (y, cache) if return_state else y


def mamba2_decode(p: Mamba2, x: torch.Tensor, cfg: HybridConfig,
                  cache: Dict[str, torch.Tensor],
                  ssm_update: UpdateFn = ops.ssm_state_update) -> torch.Tensor:
    """One token through the mixer (x: (B, 1, d)): the in-projection, then
    ``ssm_update`` for all between it and the out-projection (the conv
    step, which rolls the cache's conv state by one, the update of its SSM
    state, both in place, and the gated norm)."""
    H, P, G, N, di, conv_dim = cfg.ssm_sizes
    z, xbc, dt = apply_linear(p.in_proj, x)[:, 0].split([di, conv_dim, H], dim=-1)
    with scope("mamba2.state_update"):
        y = ssm_update(cache["ssm"], cache["conv"], z, xbc, dt, param(p, "conv_w"),
                       param(p, "conv_b"), param(p, "dt_bias"), param(p, "A_log"),
                       param(p, "D"), param(p.norm, "scale"))
    return apply_linear(p.out_proj, y[:, None])


def mamba2_cache_shape(cfg: HybridConfig, batch: int, dtype: torch.dtype
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of a Mamba-2 layer's decode cache: the conv state in
    the compute dtype, the SSM state in fp32."""
    H, P, _, N, _, conv_dim = cfg.ssm_sizes
    return {"conv": ((batch, conv_dim, cfg.conv_width - 1), dtype),
            "ssm": ((batch, H, P, N), torch.float32)}

