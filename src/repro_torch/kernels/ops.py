"""Public entry points of the port's kernels.

Each op launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor; any other device raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .flash_attention import flash_attention
from .ref import flash_attention_ref, rglru_scan_ref, ssm_state_update_ref
from .rglru_scan import rglru_scan_kernel
from .ssm_state_update import ssm_state_update_kernel
from .wkv6 import wkv6_kernel


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`attention`: GQA expanded by repeat, heads
    merged into the batch, :func:`flash_attention_ref`."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H != K:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    qm = q.transpose(1, 2).reshape(B * H, Sq, dh)
    km = k.transpose(1, 2).reshape(B * H, Sk, dh)
    vm = v.transpose(1, 2).reshape(B * H, Sk, dh)
    o = flash_attention_ref(qm, km, vm, causal=causal, window=window,
                            softcap=softcap, scale=scale)
    return o.reshape(B, H, Sq, dh).transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None, pad_heads: int = 0) -> torch.Tensor:
    """GQA flash attention.  q: (B, Sq, H, dh); k, v: (B, Sk, K, dh).
    ``pad_heads`` is taken for the signature of ``models.layers.mha`` and
    not used: padded heads are zeros that are sliced off the output."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no attention kernel for device {q.device}")


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`wkv6`: heads merged into the batch,
    :func:`ref.wkv6_ref`, heads split again.  v (and s0) may hold a block
    of the value columns, as one CTA of the kernel does."""
    B, T, H, dh = r.shape
    dv = v.shape[-1]

    def merge(x):
        return x.transpose(1, 2).reshape(B * H, T, x.shape[-1])

    u_m = u[None].expand(B, H, dh).reshape(B * H, dh)
    s0_m = None if s0 is None else s0.reshape(B * H, dh, dv)
    y, s = ref.wkv6_ref(merge(r), merge(k), merge(v), merge(logw), u_m, s0_m)
    return y.reshape(B, H, T, dv).transpose(1, 2), s.reshape(B, H, dh, dv)


def wkv6_kernel_args(r, k, v, logw, u, s0=None):
    """What :func:`wkv6` hands the kernel: the small u (a parameter, bf16 in
    a bf16 model) and the state in fp32."""
    return (r, k, v, logw.float(), u.float().contiguous(),
            None if s0 is None else s0.float())


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 recurrence.  r/k/v/logw: (B, T, H, dh); u: (H, dh); s0:
    optional (B, H, dh, dh) initial state.  Returns (y: (B, T, H, dh) in
    r's dtype, s_final: (B, H, dh, dh) fp32)."""
    if r.device.type == "cuda":
        return wkv6_kernel(*wkv6_kernel_args(r, k, v, logw, u, s0))
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u, s0)
    raise ValueError(f"no wkv6 kernel for device {r.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + b_t.  a, b: (B, S, W) fp32;
    h0: optional (B, W).  Returns h: (B, S, W) fp32."""
    if a.device.type == "cuda":
        return rglru_scan_kernel(a, b, None if h0 is None else h0.float())
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    raise ValueError(f"no rglru_scan kernel for device {a.device}")


def ssm_state_update(state: torch.Tensor, conv_state: torch.Tensor, z: torch.Tensor,
                     xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
                     conv_b: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                     D: torch.Tensor, norm_scale: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """A Mamba-2 layer's decode step between its projections (the conv
    step, the state update, the gated norm), both states in place; shapes
    as :func:`ssm_state_update_ref`.  Returns (batch, H P) in z's dtype."""
    args = (state, conv_state, z, xbc, dt, conv_w, conv_b, dt_bias, A_log, D, norm_scale, eps)
    if state.device.type == "cuda":
        return ssm_state_update_kernel(*args)
    if state.device.type == "cpu":
        return ssm_state_update_ref(*args)
    raise ValueError(f"no ssm_state_update kernel for device {state.device}")
