"""Model API of the port: parameters, init, loss, prefill and decode.

Counterpart of ``repro/models/model.py`` for decoder-only models (dense,
hybrid RG-LRU and RWKV-6 stacks).  ``forward`` / ``chunked_loss`` /
``loss_fn`` are the training path under autograd;
``Model.prefill`` / ``Model.decode_step`` mirror ``prefill`` /
``decode_step`` of the reference; ``init_params`` draws every parameter
from one ``torch.Generator`` with the reference's init rules (normal times
the spec's scale, zeros for norm scales), in ``cfg.param_dtype``.  The
numbers differ from ``jax.random``'s; parity tests carry the reference's
parameters across with ``models.params.from_jax_params`` instead.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (Embed, Linear, Norm, apply_embed, apply_logits,
                     apply_norm, sinusoidal, torch_dtype)
from .transformer import (KERNELS, Block, Cache, Kernels, run_stack,
                          run_stack_decode, run_stack_prefill)

LOSS_CHUNK = 512  # sequence-chunked cross-entropy (bounds logits memory)


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
        x = _embed_inputs(self, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x, cache = run_stack_prefill(self.layers, x, cfg, pos, s_buf, kernels)
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
        x, cache = run_stack_decode(self.layers, cache, x, cfg, pos, kernels)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x, cfg), cache


def _embed_inputs(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = apply_embed(model.embed, tokens, cfg)
    if not cfg.use_rope:
        x = x + sinusoidal(tokens.shape[1], cfg.d_model,
                           device=x.device).to(x.dtype)[None]
    return x


# ---------------------------------------------------------------------------
# Forward / loss (training, under autograd)
# ---------------------------------------------------------------------------

def forward(model: Model, tokens: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Final hidden states (B, S, d); the logits are computed chunked
    inside the loss to bound memory."""
    x = _embed_inputs(model, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = run_stack(model.layers, x, model.cfg, pos, remat=remat)
    return apply_norm(model.final_norm, x, model.cfg.norm)


def chunked_loss(model: Model, hidden: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with sequence-chunked logits: the (B, S, V)
    logits are never materialized; each chunk's are recomputed in the
    backward (checkpointed)."""
    cfg = model.cfg
    B, S, d = hidden.shape
    n = max(S // min(LOSS_CHUNK, S), 1)
    if S % n:
        raise ValueError(f"sequence length {S} does not split into {n} "
                         "equal loss chunks")
    c = S // n

    def chunk_nll(h: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        logits = apply_logits(model.logits, model.embed, h, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return torch.sum(lse - gold)

    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(n):
        total = total + checkpoint(chunk_nll, hidden[:, i * c:(i + 1) * c],
                                   labels[:, i * c:(i + 1) * c],
                                   use_reentrant=False)
    return total / (B * S)


def loss_fn(model: Model, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` ({"tokens", "labels"}: (B, S)
    integer tensors)."""
    hidden = forward(model, batch["tokens"], remat=remat)
    return chunked_loss(model, hidden, batch["labels"])


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
