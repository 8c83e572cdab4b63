"""AdamW written by hand on tensors, with global-norm clipping.

Counterpart of ``repro/optim/adamw.py`` (not ``torch.optim.AdamW``): the
same configuration, linear-warmup + cosine schedule, clipping, bias
corrections and weight decay on the base (the fp32 master where one
exists).  Parameters, gradients and moments are mappings keyed by the
model's parameter names.  ``update`` works in place under ``no_grad``
(``mul_``, ``add_``, ``addcmul_`` in the reference's order of operations),
so its transient fp32 memory is two tensors of the largest parameter's
size; it consumes the gradients (they are scaled in place).  Scalars (step,
schedule, bias corrections, clip scale) are 0-d fp32 tensors on the
parameters' device, so a step never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

from ..models.layers import torch_dtype
from ..runtime import scope

Named = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # bf16 option: gradient-state compression
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (fp32, as ``step``'s
    device)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: Named, cfg: AdamWConfig) -> Dict[str, object]:
    """{"m", "v", "step"} and, when some parameter is not fp32, an fp32
    "master" copy of every parameter (mixed precision)."""
    mdt = torch_dtype(cfg.moment_dtype)
    dev = next(iter(params.values())).device
    out: Dict[str, object] = {
        "m": {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if any(p.dtype != torch.float32 for p in params.values()):
        out["master"] = {n: p.detach().float().clone() for n, p in params.items()}
    return out


def global_norm(tree: Named) -> torch.Tensor:
    """sqrt of the sum over tensors of their summed fp32 squares (``torch.sum``
    reduces pairwise on both devices; the CPU's fp32 ``vector_norm``
    accumulates in order and drifts by ~1e-4 over a million elements)."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@scope("optimizer")
@torch.no_grad()
def update(grads: Named, opt_state: Dict[str, object], params: Named,
           cfg: AdamWConfig) -> Tuple[Named, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, opt_state, metrics
    {"grad_norm", "lr"}), the same objects as given, updated."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    master = opt_state.get("master")
    for name, p in params.items():
        g = grads[name]
        g = g.float() if g.dtype != torch.float32 else g
        g.mul_(scale)
        m, v = opt_state["m"][name], opt_state["v"][name]
        m32 = m if m.dtype == torch.float32 else m.float()
        m32.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        if m32 is not m:
            m.copy_(m32)
        delta = m32 / bc1                                  # mhat
        denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)    # sqrt(vhat) + eps
        base = p if master is None else master[name]
        delta.div_(denom).add_(base, alpha=cfg.weight_decay)
        del denom
        base.sub_(delta.mul_(lr))
        if master is not None:
            p.copy_(base)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
