"""Carry parameters between the JAX package's layout and the port's.

The reference keeps parameters as a pytree whose transformer layers are
stacked on a leading axis per group (``groups/<g>/pos<i>/...``); its
checkpoints flatten that tree by keypath, joining dict keys and tuple
indices with ``/`` (``ckpt/checkpoint.py``).  :func:`from_jax_params`
takes such a flat ``{keypath: numpy array}`` mapping, unstacks the layer
axis, and loads each slice into the port's module of the same name.  No
array is transposed: the port keeps the reference's ``(d_in, d_out)``
weight layout.  Arrays of numpy's ``bfloat16`` extension dtype are taken
bit for bit.  :func:`to_jax_params` is the inverse: it restacks the port's
layers by group into the reference's keypaths, which is what makes the two
packages' checkpoints interchangeable; ``to_jax_layout`` /
``from_jax_layout`` do the same for any mapping keyed like the model's
parameters (the optimizer's moments).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .model import Model
from .transformer import group_meta


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")        # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' extension type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _port_name(keypath: str, layer_offset: Dict[int, int],
              unit_len: Dict[int, int], rep: int) -> str:
    """Name in ``Model.state_dict()`` of repetition ``rep`` of a stacked
    reference keypath (``groups/<g>/pos<i>/<rest>``)."""
    _, g, pos, rest = keypath.split("/", 3)
    layer = layer_offset[int(g)] + rep * unit_len[int(g)] + int(pos[3:])
    return f"layers.{layer}.{rest.replace('/', '.')}"


def _layer_index(cfg: ModelConfig) -> Dict[int, Tuple[int, int, int]]:
    """Port layer -> (group, repetition, position in the unit)."""
    out, start = {}, 0
    for g, (unit, n) in enumerate(group_meta(cfg)):
        for r in range(n):
            for i in range(len(unit)):
                out[start + r * len(unit) + i] = (g, r, i)
        start += n * len(unit)
    return out


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{name}: bfloat16 arrays are not ported yet (numpy has no "
            "bfloat16 without ml_dtypes, which the port does not use)")
    return t.detach().to("cpu", copy=True).numpy()


@torch.no_grad()
def to_jax_layout(cfg: ModelConfig,
                  named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{port parameter name: tensor}`` -> ``{reference keypath: numpy
    array}``, the layers of each group stacked on a leading axis
    (``layers.3.attn.wq.w`` -> ``groups/0/pos0/attn/wq/w[3]``).  Arrays are
    copies.  A bfloat16 tensor raises ``NotImplementedError``."""
    index = _layer_index(cfg)
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    flat: Dict[str, np.ndarray] = {}
    for name, t in named.items():
        if name.startswith("layers."):
            _, layer, rest = name.split(".", 2)
            g, r, i = index[int(layer)]
            key = f"groups/{g}/pos{i}/{rest.replace('.', '/')}"
            stacks.setdefault(key, {})[r] = t
        else:
            flat[name.replace(".", "/")] = _to_numpy(name, t)
    for key, reps in stacks.items():
        flat[key] = _to_numpy(key, torch.stack([reps[r] for r in range(len(reps))]))
    return flat


def to_jax_params(model: Model) -> Dict[str, np.ndarray]:
    """The model's parameters as the reference's flat ``{keypath: numpy
    array}`` (the inverse of :func:`from_jax_params`)."""
    return to_jax_layout(model.cfg, model.state_dict())


def from_jax_layout(cfg: ModelConfig, flat: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """``{reference keypath: array}`` -> ``{port parameter name: tensor}``
    (CPU tensors; stacked layers split apart)."""
    layer_offset, unit_len, n_reps, start = {}, {}, {}, 0
    for g, (unit, n) in enumerate(group_meta(cfg)):
        layer_offset[g], unit_len[g], n_reps[g] = start, len(unit), n
        start += n * len(unit)
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        t = _to_tensor(arr)
        if key.startswith("groups/"):
            g = int(key.split("/")[1])
            if t.shape[0] != n_reps[g]:
                raise ValueError(f"{key}: leading axis {t.shape[0]} != "
                                 f"{n_reps[g]} stacked layers")
            for r in range(n_reps[g]):
                out[_port_name(key, layer_offset, unit_len, r)] = t[r]
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
                    device: Union[str, torch.device] = "cpu") -> Model:
    """A ``Model`` holding the reference's parameters (flattened by
    checkpoint keypath, e.g. ``groups/0/pos0/attn/wq/w`` of shape
    ``(n, d_model, H*dh)``).  Raises on a missing, extra or misshapen key."""
    model = Model(cfg, device)
    load_named(model.state_dict(keep_vars=True), from_jax_layout(cfg, flat))
    return model
