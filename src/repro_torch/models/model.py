"""Model API of the port: parameters, init, loss, prefill and decode.

Counterpart of ``repro/models/model.py`` for decoder-only models (dense,
MoE, hybrid RG-LRU and RWKV-6 stacks, and the port's own hybrid Mamba-2
stack, ``mamba2.HybridConfig``, which adds no position embedding), the
vision stub (pixtral: the projected patch embeddings replace the first
``n_patches`` positions) and the encoder-decoder with the audio stub
(whisper: precomputed frame
embeddings ``(B, encoder_seq, d_model)`` go through ``frame_proj``,
sinusoidal positions and the encoder stack, whose output the decoder's
cross-attention reads).  ``forward`` / ``chunked_loss`` / ``loss_fn`` are
the training path under
autograd; ``Model.prefill`` / ``Model.decode_step`` mirror ``prefill`` /
``decode_step`` of the reference; ``init_params`` draws every parameter
from one ``torch.Generator`` with the reference's init rules (normal times
the spec's scale, zeros for norm scales), in ``cfg.param_dtype``.  The
numbers differ from ``jax.random``'s; parity tests carry the reference's
parameters across with ``models.params.from_jax_params`` instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..runtime import constrain, scope
from .config import ModelConfig
from .layers import (Embed, Linear, Norm, apply_embed, apply_linear,
                     apply_logits, apply_norm, sinusoidal, torch_dtype)
from .mamba2 import HybridConfig
from .transformer import (KERNELS, Block, Cache, Kernels, init_cache,
                          run_stack, run_stack_decode, run_stack_prefill)

LOSS_CHUNK = 512  # sequence-chunked cross-entropy (bounds logits memory)


class Model(nn.Module):
    """The LM: decoder ``layers`` (with ``patch_proj`` for the vision
    stub; for an encoder-decoder also ``enc_layers``, plain ``"global"``
    blocks, ``enc_norm`` and ``frame_proj``, and a cross-attention in every
    decoder block).  On the card unless ``device`` is ``"cpu"``
    (``device.resolve_device``: no fallback).  Parameters are
    uninitialized until :func:`init_params` or ``params.from_jax_params``
    fills them."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, kind, device, cross=cfg.is_encdec)
                                    for kind in cfg.layer_kinds)
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.logits = (None if cfg.tie_embeddings else
                       Linear(cfg.d_model, cfg.vocab_size, ("embed", "vocab"),
                              dtype=dtype, device=device))
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(Block(cfg, "global", device)
                                            for _ in range(cfg.encoder_layers))
            self.enc_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
            self.frame_proj = Linear(cfg.d_model, cfg.d_model, ("embed", "embed2"),
                                     dtype=dtype, device=device)
        if cfg.frontend == "vision_stub":
            self.patch_proj = Linear(cfg.d_model, cfg.d_model, ("embed", "embed2"),
                                     dtype=dtype, device=device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_buf: int,
                kernels: Kernels = KERNELS,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (last-position logits (B, 1, V) fp32, decode
        cache with ``s_buf`` slots per attention layer).  ``kernels``:
        ``transformer.KERNELS`` (the serving path) or ``PLAIN``;
        ``patches``: the vision stub's (B, n_patches, d_model) embeddings;
        ``frames``: an encoder-decoder's (B, encoder_seq, d_model) frame
        embeddings, which it requires.  The encoder runs here, its
        attention through ``kernels`` too, and each decoder layer's cache
        also keeps its cross-attention's K/V (``cross_k``, ``cross_v``)."""
        cfg = self.cfg
        x = _embed_inputs(self, tokens, patches)
        enc = _encode(self, frames, kernels) if cfg.is_encdec else None
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x, cache = run_stack_prefill(self.layers, x, cfg, pos, s_buf, kernels,
                                     encoder_out=enc)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x[:, -1:], cfg), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: int, cache: Cache,
                    kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, Cache]:
        """One-token decode: tokens (B, 1) at position ``pos`` -> (logits
        (B, 1, V), cache).  The cache is updated in place (the reference
        returns a new one) and returned; an encoder-decoder's
        cross-attention reads the prefill's encoder K/V from it."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens, cfg)
        if sinusoidal_positions(cfg):
            x = x + _sin_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None]
        x, cache = run_stack_decode(self.layers, cache, x, cfg, pos, kernels)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return apply_logits(self.logits, self.embed, x, cfg), cache


def input_specs(cfg: ModelConfig, batch: int, seq: int,
                mode: str = "train") -> Dict[str, object]:
    """Stand-ins for every model input on the ``meta`` device (no
    allocation), of the reference's shapes and dtypes: int32 tokens (and
    labels in training), the vision stub's patches and an
    encoder-decoder's frames in the compute dtype; in decode one token per
    request, an int32 position and the decode cache for ``seq`` positions
    in the port's layout (one dict per layer, ``transformer.init_cache``)."""
    i32, meta = torch.int32, "meta"
    cdt = torch_dtype(cfg.compute_dtype)
    if mode in ("train", "prefill"):
        out: Dict[str, object] = {"tokens": torch.empty((batch, seq), dtype=i32,
                                                        device=meta)}
        if mode == "train":
            out["labels"] = torch.empty((batch, seq), dtype=i32, device=meta)
        if cfg.frontend == "vision_stub":
            out["patches"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                         dtype=cdt, device=meta)
        if cfg.is_encdec:
            out["frames"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                                        dtype=cdt, device=meta)
        return out
    if mode == "decode":
        return {"tokens": torch.empty((batch, 1), dtype=i32, device=meta),
                "pos": torch.empty((), dtype=i32, device=meta),
                "cache": init_cache(cfg, batch, seq, meta)}
    raise ValueError(mode)


def sinusoidal_positions(cfg: ModelConfig) -> bool:
    """Whether the embedding adds sinusoidal positions: where the attention
    takes no rope (whisper, rwkv6), as the reference does; never in a
    hybrid Mamba-2 stack, whose attention has no position embedding."""
    return not cfg.use_rope and not isinstance(cfg, HybridConfig)


@scope("embed")
def _embed_inputs(model: Model, tokens: torch.Tensor,
                  patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    cfg = model.cfg
    x = apply_embed(model.embed, tokens, cfg)
    if cfg.frontend == "vision_stub" and patches is not None:
        pe = apply_linear(model.patch_proj, patches.to(x.dtype))
        x = torch.cat([pe, x[:, cfg.n_patches:]], dim=1)
    if sinusoidal_positions(cfg):
        x = x + sinusoidal(tokens.shape[1], cfg.d_model,
                           device=x.device).to(x.dtype)[None]
    return x


@scope("encoder")
def _encode(model: Model, frames: Optional[torch.Tensor],
            kernels: Optional[Kernels] = None, remat: bool = True) -> torch.Tensor:
    """The encoder: ``frame_proj`` of the frames (in the compute dtype, as
    the reference's ``input_specs`` gives them), sinusoidal positions, the
    encoder stack without a causal mask, ``enc_norm``.  Through
    ``kernels``' attention on the serving path; the plain ``mha`` under
    autograd (``kernels`` None) in training."""
    cfg = model.cfg
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it takes frames "
                         f"(B, {cfg.encoder_seq}, {cfg.d_model}) beside the tokens")
    x = apply_linear(model.frame_proj, frames.to(torch_dtype(cfg.compute_dtype)))
    x = x + sinusoidal(frames.shape[1], cfg.d_model, device=x.device).to(x.dtype)[None]
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = run_stack(model.enc_layers, x, cfg, pos, causal=False, remat=remat,
                  kernels=kernels, name="enc_layers")
    return apply_norm(model.enc_norm, x, cfg.norm)


# ---------------------------------------------------------------------------
# Forward / loss (training, under autograd)
# ---------------------------------------------------------------------------

def forward(model: Model, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            remat: bool = True) -> torch.Tensor:
    """Final hidden states (B, S, d); the logits are computed chunked
    inside the loss to bound memory.  An encoder-decoder requires
    ``frames``."""
    cfg = model.cfg
    x = _embed_inputs(model, tokens, patches)
    enc = _encode(model, frames, remat=remat) if cfg.is_encdec else None
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = run_stack(model.layers, x, cfg, pos, encoder_out=enc, remat=remat)
    with scope("final_norm"):
        return apply_norm(model.final_norm, x, cfg.norm)


@scope("loss")
def chunked_loss(model: Model, hidden: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with sequence-chunked logits: the (B, S, V)
    logits are never materialized; each chunk's are recomputed in the
    backward (checkpointed) when there are several.  One chunk is not
    checkpointed: its logits would live in the backward all the same, so
    the recompute would save no memory, and the reference's compiled step
    keeps them too (XLA merges the recompute of its one-trip scan with the
    forward)."""
    cfg = model.cfg
    B, S, d = hidden.shape
    n = max(S // min(LOSS_CHUNK, S), 1)
    if S % n:
        raise ValueError(f"sequence length {S} does not split into {n} "
                         "equal loss chunks")
    c = S // n

    def chunk_nll(h: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        logits = apply_logits(model.logits, model.embed, h, cfg)
        logits = constrain(logits, "batch", None, "vocab")
        lse = torch.logsumexp(logits, dim=-1)
        # (B, c, 1) as gathered: a DTensor's gather from vocab shards is a
        # masked partial sum, which it cannot reduce after a select
        gold = torch.gather(logits, -1, lab[..., None].long())
        return torch.sum(lse[..., None] - gold)

    hs = [constrain(hidden[:, i * c:(i + 1) * c], "batch") for i in range(n)]
    ls = [constrain(labels[:, i * c:(i + 1) * c], "batch") for i in range(n)]
    if n == 1:
        return chunk_nll(hs[0], ls[0]) / (B * S)
    total = hidden.new_zeros((), dtype=torch.float32)
    for h, lab in zip(hs, ls):
        total = total + checkpoint(chunk_nll, h, lab, use_reentrant=False)
    return total / (B * S)


def loss_fn(model: Model, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` ({"tokens", "labels"}: (B, S)
    integer tensors; "patches" for the vision stub, optional; "frames"
    for an encoder-decoder)."""
    hidden = forward(model, batch["tokens"], patches=batch.get("patches"),
                     frames=batch.get("frames"), remat=remat)
    return chunked_loss(model, hidden, batch["labels"])


def _sin_at(pos: int, d: int, device) -> torch.Tensor:
    """(d,) sinusoidal position ``pos`` (the decode step's)."""
    return sinusoidal(1, d, pos, device)[0]


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Model:
    """A model with deterministic random weights: every weight matrix and
    the embedding ~ normal x its init scale, norm scales (and biases) 0, the
    recurrent and MoE blocks' own parameters by their rules
    (``init_rules``).  On the card unless ``device`` is ``"cpu"``
    (``device.resolve_device``: no fallback)."""
    device = resolve_device(device)
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
