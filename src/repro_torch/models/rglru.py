"""Griffin / RecurrentGemma recurrent block (RG-LRU + temporal conv), PyTorch.

Counterpart of ``repro/models/rglru.py`` (De et al., arXiv:2402.19427):
    x  -> linear(d -> rw) -> causal conv1d(width w) -> RG-LRU -> * gelu(gate)
    gate = linear(d -> rw)
    out  = linear(rw -> d)

RG-LRU recurrence (per channel):
    r_t = sigmoid(block_diag(W_a) x_t + b_a)       recurrence gate
    i_t = sigmoid(block_diag(W_x) x_t + b_x)       input gate
    a_t = exp(-c * softplus(lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``apply_rglru`` runs the scan through ``kernels.ops.rglru_scan`` (the Hopper
kernel K2 on the card, its plain sequential version on the CPU), with the
carried state as h0 on decode.  ``rglru_scan`` here is the plain log-depth
associative form of the reference's sequence path, in its order of sums.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..runtime import block_local, pad
from .layers import Linear, apply_linear, gelu, param, raw_params

RGLRU_C = 8.0
GATE_BLOCKS = 16  # block-diagonal gate projections (Griffin uses per-head blocks)

ScanFn = Callable[..., torch.Tensor]


class RGLRU(nn.Module):
    """Every key of the reference's ``rglru_spec`` under its name."""

    def __init__(self, cfg, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, rw = cfg.d_model, cfg.rnn_width or cfg.d_model
        blk = rw // GATE_BLOCKS
        kw = dict(dtype=dtype, device=device)
        self.wx = Linear(d, rw, ("embed", "rnn"), **kw)
        self.wgate = Linear(d, rw, ("embed", "rnn"), **kw)
        raw_params(self, {
            "conv": ((cfg.conv_width, rw), (None, "rnn"), "normal",
                     1.0 / math.sqrt(cfg.conv_width)),
            "conv_b": ((rw,), ("rnn",), "zeros", 0.0),
            "gate_a": ((GATE_BLOCKS, blk, blk), (None, "rnn", None), "normal",
                       1.0 / math.sqrt(blk)),
            "gate_a_b": ((rw,), ("rnn",), "zeros", 0.0),
            "gate_x": ((GATE_BLOCKS, blk, blk), (None, "rnn", None), "normal",
                       1.0 / math.sqrt(blk)),
            "gate_x_b": ((rw,), ("rnn",), "zeros", 0.0),
            "lam": ((rw,), ("rnn",), "ones", 0.0),   # softplus(lam) > 0
        }, dtype, device)
        self.wo = Linear(rw, d, ("rnn", "embed"), **kw)


def _block_diag(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., rw) -> block-diagonal linear with GATE_BLOCKS blocks.
    Inside a sharding context each device computes its own blocks
    (``runtime.block_local``)."""
    blk = w.shape[1]

    def blocks(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        xs = x.reshape(*x.shape[:-1], w.shape[0], blk)
        y = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
        return y.reshape(x.shape) + b.to(x.dtype)

    return block_local(blocks, w, b, x)


def _gates(p: RGLRU, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (a_t decay in fp32, gated input in fp32)."""
    r = torch.sigmoid(_block_diag(param(p, "gate_a"), param(p, "gate_a_b"), xc).float())
    i = torch.sigmoid(_block_diag(param(p, "gate_x"), param(p, "gate_x_b"), xc).float())
    log_a = -RGLRU_C * F.softplus(param(p, "lam").float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * xc.float()
    return a, gated


def causal_conv1d(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal temporal conv.  x: (B, S, rw)."""
    w = param(p, "conv").to(x.dtype)        # (taps, rw)
    taps = w.shape[0]
    xp = pad(x, (0, 0, taps - 1, 0))
    out = torch.zeros_like(x)
    for t in range(taps):                   # taps is tiny (4): unrolled
        out = out + xp[:, t:t + x.shape[1]] * w[t]
    return out + param(p, "conv_b").to(x.dtype)


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return al * ar, br + ar * bl


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs (a, b) along axis 1 under ``_combine``,
    in the order of ``jax.lax.associative_scan`` (pairwise reduce, recurse
    on the odd positions, fill in the even ones), so that the sums round
    where the reference's round."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                      (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_prev = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_prev = odd
    even = _combine(odd_prev, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1), torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def rglru_scan(a: torch.Tensor, gated: torch.Tensor,
               h0: Optional[torch.Tensor] = None, chunk: int = 512) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + gated_t over axis 1, as the reference's
    log-depth associative scan (over 512-step chunks, the state carried
    between them, when the length is a multiple of the chunk).

    a, gated: (B, S, rw) fp32.  h0: optional initial state (B, rw)."""
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None], gated[:, 1:]], dim=1)
    S = a.shape[1]
    if S <= chunk or S % chunk:
        return _associative_scan(a, gated)[1]
    h = a.new_zeros((a.shape[0], a.shape[2]))
    hs = []
    for c in range(0, S, chunk):
        ac, gc = a[:, c:c + chunk], gated[:, c:c + chunk]
        gc = torch.cat([gc[:, :1] + ac[:, :1] * h[:, None], gc[:, 1:]], dim=1)
        hc = _associative_scan(ac, gc)[1]
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1)


def apply_rglru(p: RGLRU, x: torch.Tensor, cfg,
                state: Optional[Dict[str, torch.Tensor]] = None,
                return_state: bool = False, scan: ScanFn = ops.rglru_scan):
    """Full recurrent block.  x: (B, S, d).

    ``state`` (decode): {"h": (B, rw), "conv": (B, taps-1, rw)}.  ``scan`` is
    the recurrence: ``kernels.ops.rglru_scan`` on the serving path, the plain
    ``rglru_scan`` for comparisons."""
    xb = apply_linear(p.wx, x)
    gate = apply_linear(p.wgate, x)
    taps = p.conv.shape[0]
    if state is not None:
        xb_ext = torch.cat([state["conv"].to(xb.dtype), xb], dim=1)
        xc = causal_conv1d(p, xb_ext)[:, taps - 1:]
    else:
        # zeros before the prompt, as the conv's own padding
        xb_ext = pad(xb, (0, 0, taps - 1, 0))
        xc = causal_conv1d(p, xb)
    new_conv = xb_ext[:, xb_ext.shape[1] - (taps - 1):]
    a, gated = _gates(p, xc)
    h0 = state["h"].float() if state is not None else None
    h = scan(a, gated, h0)
    y = h.to(x.dtype) * gelu(gate)
    out = apply_linear(p.wo, y)
    if return_state:
        # copies, not views: the views would pin the whole prompt's tensors
        return out, {"h": h[:, -1].contiguous(), "conv": new_conv.float().contiguous()}
    return out


def rglru_decode(p: RGLRU, x: torch.Tensor, cfg, state: Dict[str, torch.Tensor],
                 scan: ScanFn = ops.rglru_scan
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step (S == 1)."""
    return apply_rglru(p, x, cfg, state=state, return_state=True, scan=scan)


def init_rglru_state(cfg, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    rw = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, rw), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, rw),
                                dtype=torch.float32, device=device)}
