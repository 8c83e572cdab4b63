"""Wrapper of the Hopper Mamba-2 decode step, K4 (``csrc/ssm_state_update.cu``).

The kernel replaces no TPU kernel (the JAX package has no Mamba-2 layer);
the note in the source gives its bound and design.  One call runs a
Mamba-2 layer's decode step between its projections: the conv step (the
conv state rolled by one), the state update and the gated norm.  It takes
the layout of ``models.mamba2``'s decode step directly: the SSM state
``(B, H, P, N)`` fp32 and the conv state ``(B, conv_dim, taps - 1)``,
both updated in place; z, xbc and dt as column slices of the
in-projection's output rows (their row strides are passed, so nothing is
copied); the layer's weights as they are.  Activations and weights are
each fp32 or bf16.  It checks device, dtype, shape, contiguity and the
16-byte alignment of the state, and raises on anything else, allocates
its scratch and output with ``torch.empty``, launches on the current
stream without synchronizing, and raises on the launch's ``cudaError_t``.
``ssm_state_update_kernel.launches`` counts the calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import _check_cuda

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
ROWS_PER_CTA = 16        # ROWS in csrc/ssm_state_update.cu
TAPS = 4                 # TAPS there
STATE = 256              # STATE there: the state size N
ALIGN = 16               # bytes, for the float4 loads

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# state, cstate, z, xbc, dt, conv_w, conv_b, dt_bias, a_log, D, scale, u, y,
# out, act_bf16, w_bf16, batch, H, G, P, N, taps, 3 row strides, eps, stream
ARGTYPES = [_P] * 14 + [_I] * 8 + [_L] * 3 + [ctypes.c_float, _P]
C_ENTRIES = {"ssm_state_update_launch": ARGTYPES}


@functools.cache
def _kernel():
    """The C entry point ``ssm_state_update_launch``, built and typed once."""
    fn = _build.load("ssm_state_update").ssm_state_update_launch
    fn.argtypes = ARGTYPES
    fn.restype = _I
    return fn


def check_inputs(state, conv_state, z, xbc, dt, conv_w, conv_b, dt_bias, A_log, D,
                 norm_scale) -> None:
    """Raise unless the kernel takes these tensors (device aside)."""
    acts = (("conv_state", conv_state), ("z", z), ("xbc", xbc), ("dt", dt))
    weights = (("conv_w", conv_w), ("conv_b", conv_b), ("dt_bias", dt_bias),
               ("A_log", A_log), ("D", D), ("norm_scale", norm_scale))
    for name, t in (("state", state),) + acts + weights:
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.device}")
    if state.dtype != torch.float32:
        raise TypeError(f"state has dtype {state.dtype}; the kernel keeps it in float32")
    for group in (acts, weights):
        for name, t in group:
            if t.dtype != group[0][1].dtype or t.dtype not in SUPPORTED_DTYPES:
                raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                                f"{group[0][1].dtype} in {SUPPORTED_DTYPES}")
    if state.dim() != 4:
        raise ValueError(f"state must be (B, H, P, N), got {tuple(state.shape)}")
    batch, H, P, N = state.shape
    conv = xbc.shape[-1]
    G = (conv - H * P) // (2 * N)
    shapes = {"conv_state": (batch, conv, TAPS - 1), "z": (batch, H * P), "xbc": (batch, conv),
              "dt": (batch, H), "conv_w": (conv, TAPS), "conv_b": (conv,), "dt_bias": (H,),
              "A_log": (H,), "D": (H,), "norm_scale": (H * P,)}
    for name, t in acts + weights:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if N != STATE:
        raise ValueError(f"state size {N}; the kernel takes {STATE}")
    if G <= 0 or conv != H * P + 2 * G * N or H % G or P % ROWS_PER_CTA:
        raise ValueError(f"unsupported sizes H={H}, P={P}, N={N}, conv={conv}")
    if not 0 < batch <= 65535:
        raise ValueError(f"unsupported batch {batch}")
    for name, t in (("state", state), ("conv_state", conv_state)) + weights:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("z", z), ("xbc", xbc), ("dt", dt)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous within each batch row")
    if state.data_ptr() % ALIGN:
        raise ValueError(f"state must start on a {ALIGN}-byte boundary")


def ssm_state_update_kernel(state: torch.Tensor, conv_state: torch.Tensor, z: torch.Tensor,
                            xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
                            conv_b: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                            D: torch.Tensor, norm_scale: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """One Mamba-2 layer's decode step between its projections on the card,
    both states in place.  Shapes as ``ref.ssm_state_update_ref``; returns
    the gated norm's output (batch, H P) in z's dtype."""
    _check_cuda(state=state, conv_state=conv_state, z=z, xbc=xbc, dt=dt)
    check_inputs(state, conv_state, z, xbc, dt, conv_w, conv_b, dt_bias, A_log, D, norm_scale)
    batch, H, P, N = state.shape
    conv = xbc.shape[-1]
    G = (conv - H * P) // (2 * N)
    with torch.cuda.device(state.device):
        u = torch.empty((batch, conv), dtype=torch.float32, device=state.device)
        y = torch.empty((batch, H * P), dtype=torch.float32, device=state.device)
        out = torch.empty((batch, H * P), dtype=z.dtype, device=state.device)
        err = _kernel()(
            state.data_ptr(), conv_state.data_ptr(), z.data_ptr(), xbc.data_ptr(),
            dt.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
            A_log.data_ptr(), D.data_ptr(), norm_scale.data_ptr(), u.data_ptr(), y.data_ptr(),
            out.data_ptr(), int(z.dtype == torch.bfloat16), int(D.dtype == torch.bfloat16),
            batch, H, G, P, N, TAPS, z.stride(0), xbc.stride(0), dt.stride(0), eps,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssm_state_update_launch failed: cudaError_t {err}")
    ssm_state_update_kernel.launches += 1
    return out


ssm_state_update_kernel.launches = 0
