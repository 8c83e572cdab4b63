"""Model API of the port: parameters, init, prefill and decode.

Counterpart of ``repro/models/model.py`` for decoder-only models (dense,
hybrid RG-LRU and RWKV-6 stacks).
``Model.prefill`` / ``Model.decode_step`` mirror ``prefill`` /
``decode_step`` of the reference; ``init_params`` draws every parameter
from one ``torch.Generator`` with the reference's init rules (normal times
the spec's scale, zeros for norm scales), in ``cfg.param_dtype``.  The
numbers differ from ``jax.random``'s; parity tests carry the reference's
parameters across with ``models.params.from_jax_params`` instead.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .config import ModelConfig
from .layers import (Embed, Linear, Norm, apply_embed, apply_logits,
                     apply_norm, sinusoidal, torch_dtype)
from .transformer import (KERNELS, Block, Cache, Kernels, block_decode,
                          block_forward)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for features whose slice has not landed (the model would
    otherwise silently compute something else)."""
    missing = [name for name, on in (
        ("encoder-decoder", cfg.is_encdec),
        ("vision/audio frontend", cfg.frontend != "none"),
        ("post-norm", cfg.post_norm)) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  "ported yet (later slices of the port)")


class Model(nn.Module):
    """Decoder-only LM.  Parameters are uninitialized until
    :func:`init_params` or ``params.from_jax_params`` fills them."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device] = "cpu"):
        super().__init__()
        check_supported(cfg)
        dtype = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.layer_kinds)
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.logits = (None if cfg.tie_embeddings else
                       Linear(cfg.d_model, cfg.vocab_size, dtype=dtype,
                              device=device))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_buf: int,
                kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (last-position logits (B, 1, V) fp32, decode
        cache with ``s_buf`` slots per attention layer).  ``kernels``:
        ``transformer.KERNELS`` (the serving path) or ``PLAIN``."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens, cfg)
        S = tokens.shape[1]
        if not cfg.use_rope:
            x = x + sinusoidal(S, cfg.d_model, device=x.device).to(x.dtype)[None]
        pos = torch.arange(S, device=tokens.device)
        cache: Cache = []
        for layer in self.layers:
            x, c = block_forward(layer.kind, layer, x, cfg, pos, s_buf, kernels)
            cache.append(c)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x[:, -1:], cfg), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: int, cache: Cache,
                    kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, Cache]:
        """One-token decode: tokens (B, 1) at position ``pos`` -> (logits
        (B, 1, V), cache).  The cache is updated in place (the reference
        returns a new one) and returned."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens, cfg)
        if not cfg.use_rope:
            x = x + _sin_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None]
        for layer, c in zip(self.layers, cache):
            x, _ = block_decode(layer.kind, layer, x, c, cfg, pos, kernels)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x, cfg), cache


def _sin_at(pos: int, d: int, device) -> torch.Tensor:
    """(d,) sinusoidal position ``pos`` (the decode step's)."""
    return sinusoidal(1, d, pos, device)[0]


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> Model:
    """A model with deterministic random weights: every weight matrix and
    the embedding ~ normal x its init scale, norm scales (and biases) 0, the
    recurrent blocks' own parameters by their rules (``init_rules``)."""
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(w: torch.Tensor, scale: float) -> None:
        w.copy_(scale * torch.randn(w.shape, generator=gen, dtype=torch.float32,
                                    device=w.device))

    for module in model.modules():
        for name, (init, scale) in getattr(module, "init_rules", {}).items():
            w = getattr(module, name)
            if init == "normal":
                normal(w, scale)
            else:
                w.fill_(1.0 if init == "ones" else 0.0)
        if isinstance(module, Norm):
            for p in (module.scale, module.bias):
                if p is not None:
                    p.zero_()
        elif isinstance(module, (Linear, Embed)):
            normal(module.w if isinstance(module, Linear) else module.table,
                   module.init_scale)
            if isinstance(module, Linear) and module.b is not None:
                module.b.zero_()
    return model
