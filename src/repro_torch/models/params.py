"""Carry parameters between the JAX package's layout and the port's.

The reference keeps parameters as a pytree whose transformer layers are
stacked on a leading axis per group (``groups/<g>/pos<i>/...``); its
checkpoints flatten that tree by keypath, joining dict keys and tuple
indices with ``/`` (``ckpt/checkpoint.py``).  :func:`from_jax_params`
takes such a flat ``{keypath: numpy array}`` mapping, unstacks the layer
axis (a MoE block's ``moe/wi`` is an ``(n, E, d, f)`` stack like any other
layer leaf; an encoder-decoder's encoder is stacked likewise under
``enc_groups/0/pos0/...``, its decoder blocks' cross-attention under
``groups/0/pos0/cross/...``), and loads each slice into the port's module
of the same name (top-level leaves such as ``patch_proj/w``,
``frame_proj/w`` and ``enc_norm/scale`` keep their place).  No
array is transposed: the port keeps the reference's ``(d_in, d_out)``
weight layout.  bfloat16 arrays, numpy ``V2`` (how either package's
checkpoint loads them) or ml_dtypes' ``bfloat16``, are taken bit for bit.
:func:`to_jax_params` is the inverse (bfloat16 tensors as ``V2``): it
restacks the port's layers by group into the reference's keypaths, which
is what makes the two packages' checkpoints interchangeable;
``to_jax_layout`` / ``from_jax_layout`` do the same for any mapping keyed
like the model's parameters (the optimizer's moments).  :func:`param_axes` gives every
parameter's logical sharding axes under the same keypaths.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..ckpt.checkpoint import to_numpy, to_tensor
from ..device import resolve_device
from .config import ModelConfig
from .model import Model
from .transformer import group_meta


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")       # a writable copy
    return to_tensor(a)


def _stacks(cfg: ModelConfig) -> Tuple[Tuple[str, str, Tuple], ...]:
    """(reference prefix, port prefix, group layout) of each layer stack:
    the decoder's ``groups`` / ``layers``, and an encoder-decoder's
    ``enc_groups`` / ``enc_layers`` (one group of plain ``"global"``
    blocks, as the reference's ``param_specs`` stacks them)."""
    out = [("groups", "layers", group_meta(cfg))]
    if cfg.is_encdec:
        out.append(("enc_groups", "enc_layers", ((("global",), cfg.encoder_layers),)))
    return tuple(out)


def _layer_index(meta) -> Dict[int, Tuple[int, int, int]]:
    """Layer of a stack -> (group, repetition, position in the unit)."""
    out, start = {}, 0
    for g, (unit, n) in enumerate(meta):
        for r in range(n):
            for i in range(len(unit)):
                out[start + r * len(unit) + i] = (g, r, i)
        start += n * len(unit)
    return out


def _jax_keys(cfg: ModelConfig, names) -> Dict[str, Tuple[str, Optional[int]]]:
    """Port parameter name -> (reference keypath, repetition on the stacked
    layer axis, or None for a leaf that is not stacked)."""
    index = {port: (ref, _layer_index(meta)) for ref, port, meta in _stacks(cfg)}
    out = {}
    for name in names:
        head, _, tail = name.partition(".")
        if head in index:
            layer, rest = tail.split(".", 1)
            ref, layers = index[head]
            g, r, i = layers[int(layer)]
            out[name] = (f"{ref}/{g}/pos{i}/{rest.replace('.', '/')}", r)
        else:
            out[name] = (name.replace(".", "/"), None)
    return out


def named_param_axes(model: Model) -> Dict[str, Tuple[Optional[str], ...]]:
    """``{port parameter name: logical axes}``, from each parameter's
    container (``axes``), as the port's layers hold them: one layer at a
    time, with no ``"layers"`` axis."""
    out = {}
    for name, _ in model.named_parameters():
        owner, _, attr = name.rpartition(".")
        out[name] = tuple(model.get_submodule(owner).axes[attr])
    return out


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """``{reference keypath: logical axes}`` of every parameter, stacked
    leaves with the leading ``"layers"`` axis: the counterpart of the
    reference's ``layers.spec_axes(param_specs(cfg))``, flattened by
    keypath (read from a model on the ``meta`` device)."""
    axes = named_param_axes(Model(cfg, "meta"))
    out = {}
    for name, (key, rep) in _jax_keys(cfg, axes).items():
        out[key] = axes[name] if rep is None else ("layers",) + axes[name]
    return out


@torch.no_grad()
def to_jax_layout(cfg: ModelConfig,
                  named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{port parameter name: tensor}`` -> ``{reference keypath: numpy
    array}``, the layers of each group stacked on a leading axis
    (``layers.3.attn.wq.w`` -> ``groups/0/pos0/attn/wq/w[3]``,
    ``enc_layers.1.mlp.wi.w`` -> ``enc_groups/0/pos0/mlp/wi/w[1]``).
    Arrays are copies; a bfloat16 tensor's bits come as numpy ``V2``, as a
    bfloat16 leaf of the reference's checkpoints loads."""
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    flat: Dict[str, np.ndarray] = {}
    for name, (key, rep) in _jax_keys(cfg, named).items():
        if rep is not None:
            stacks.setdefault(key, {})[rep] = named[name]
        else:
            flat[key] = to_numpy(named[name])
    for key, reps in stacks.items():
        flat[key] = to_numpy(torch.stack([reps[r] for r in range(len(reps))]))
    return flat


def to_jax_params(model: Model) -> Dict[str, np.ndarray]:
    """The model's parameters as the reference's flat ``{keypath: numpy
    array}`` (the inverse of :func:`from_jax_params`)."""
    return to_jax_layout(model.cfg, model.state_dict())


def from_jax_layout(cfg: ModelConfig, flat: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """``{reference keypath: array}`` -> ``{port parameter name: tensor}``
    (CPU tensors, sharing memory with the arrays that are writable and
    C-contiguous, copies of the others; stacked layers split apart)."""
    groups = {}    # (reference prefix, group) -> (port prefix, first layer, unit length, n)
    for ref, port, meta in _stacks(cfg):
        start = 0
        for g, (unit, n) in enumerate(meta):
            groups[(ref, str(g))] = (port, start, len(unit), n)
            start += n * len(unit)
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        t = _to_tensor(arr)
        parts = key.split("/", 3)
        group = groups.get(tuple(parts[:2])) if len(parts) == 4 else None
        if group is not None:
            port, first, unit_len, n = group
            pos, path = parts[2:]
            if t.shape[0] != n:
                raise ValueError(f"{key}: leading axis {t.shape[0]} != "
                                 f"{n} stacked layers")
            for r in range(n):
                layer = first + r * unit_len + int(pos[3:])
                out[f"{port}.{layer}.{path.replace('/', '.')}"] = t[r]
        else:
            out[key.replace("/", ".")] = t
    return out


@torch.no_grad()
def load_named(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
               what: str = "the reference") -> None:
    """Copy every tensor of ``src`` into the tensor of the same name in
    ``dst`` (cast to its dtype).  Raises on a missing, extra or misshapen
    name."""
    loaded = set()
    for name, value in src.items():
        if name not in dst:
            raise KeyError(f"{name}: no parameter {name!r} in the port")
        target = dst[name]
        if tuple(target.shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(target.shape)} of {name}")
        target.copy_(value.to(target.dtype))
        loaded.add(name)
    missing = sorted(set(dst) - loaded)
    if missing:
        raise KeyError(f"parameters absent from {what}: {missing}")


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, flat: Mapping[str, np.ndarray],
                    device: Union[str, torch.device] = "cuda") -> Model:
    """A ``Model`` holding the reference's parameters (flattened by
    checkpoint keypath, e.g. ``groups/0/pos0/attn/wq/w`` of shape
    ``(n, d_model, H*dh)``, ``groups/0/pos0/moe/wi`` of shape ``(n, E, d,
    f)``), on the card unless ``device`` is ``"cpu"``.  Raises on a
    missing, extra or misshapen key."""
    model = Model(cfg, resolve_device(device))
    load_named(model.state_dict(keep_vars=True), from_jax_layout(cfg, flat))
    return model
