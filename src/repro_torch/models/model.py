"""Model API of the port: parameters, init, prefill and decode.

Counterpart of ``repro/models/model.py`` for decoder-only dense models.
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

from ..kernels import ops
from .config import ModelConfig
from .layers import (Embed, Linear, Norm, apply_embed, apply_logits,
                     apply_norm, torch_dtype)
from .transformer import (AttentionFn, Block, Cache, block_decode,
                          block_forward)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for features whose slice has not landed (the model would
    otherwise silently compute something else)."""
    missing = [name for name, on in (
        ("encoder-decoder", cfg.is_encdec),
        ("vision/audio frontend", cfg.frontend != "none"),
        ("sinusoidal positions", not cfg.use_rope),
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
                attention: AttentionFn = ops.attention
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (last-position logits (B, 1, V) fp32, decode
        cache with ``s_buf`` slots per layer)."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens, cfg)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        cache: Cache = []
        for layer in self.layers:
            x, c = block_forward(layer.kind, layer, x, cfg, pos, s_buf,
                                 attention)
            cache.append(c)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x[:, -1:], cfg), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: int,
                    cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One-token decode: tokens (B, 1) at position ``pos`` -> (logits
        (B, 1, V), cache).  The cache is updated in place (the reference
        returns a new one) and returned."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens, cfg)
        for layer, c in zip(self.layers, cache):
            x, _ = block_decode(layer.kind, layer, x, c, cfg, pos)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x, cfg), cache


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> Model:
    """A model with deterministic random weights: every weight matrix and
    the embedding ~ normal x its init scale, norm scales (and biases) 0."""
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, Norm):
            for p in (module.scale, module.bias):
                if p is not None:
                    p.zero_()
        elif isinstance(module, (Linear, Embed)):
            w = module.w if isinstance(module, Linear) else module.table
            w.copy_(module.init_scale * torch.randn(
                w.shape, generator=gen, dtype=torch.float32, device=w.device))
            if isinstance(module, Linear) and module.b is not None:
                module.b.zero_()
    return model
