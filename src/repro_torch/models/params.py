"""Carry the JAX package's parameters into the port.

The reference keeps parameters as a pytree whose transformer layers are
stacked on a leading axis per group (``groups/<g>/pos<i>/...``); its
checkpoints flatten that tree by keypath, joining dict keys and tuple
indices with ``/`` (``ckpt/checkpoint.py``).  :func:`from_jax_params`
takes such a flat ``{keypath: numpy array}`` mapping, unstacks the layer
axis, and loads each slice into the port's module of the same name.  No
array is transposed: the port keeps the reference's ``(d_in, d_out)``
weight layout.  Arrays of numpy's ``bfloat16`` extension dtype are taken
bit for bit.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

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


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, flat: Mapping[str, np.ndarray],
                    device: Union[str, torch.device] = "cpu") -> Model:
    """A ``Model`` holding the reference's parameters (flattened by
    checkpoint keypath, e.g. ``groups/0/pos0/attn/wq/w`` of shape
    ``(n, d_model, H*dh)``).  Raises on a missing, extra or misshapen key."""
    model = Model(cfg, device)
    params = model.state_dict(keep_vars=True)
    layer_offset, unit_len, n_reps, start = {}, {}, {}, 0
    for g, (unit, n) in enumerate(group_meta(cfg)):
        layer_offset[g], unit_len[g], n_reps[g] = start, len(unit), n
        start += n * len(unit)

    loaded = set()
    for key, arr in flat.items():
        t = _to_tensor(arr)
        if key.startswith("groups/"):
            g = int(key.split("/")[1])
            if t.shape[0] != n_reps[g]:
                raise ValueError(f"{key}: leading axis {t.shape[0]} != "
                                 f"{n_reps[g]} stacked layers")
            pairs = [(_port_name(key, layer_offset, unit_len, r), t[r])
                     for r in range(n_reps[g])]
        else:
            pairs = [(key.replace("/", "."), t)]
        for name, value in pairs:
            if name not in params:
                raise KeyError(f"{key}: no parameter {name!r} in the port")
            dst = params[name]
            if tuple(dst.shape) != tuple(value.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != "
                                 f"{tuple(dst.shape)} of {name}")
            dst.copy_(value.to(dst.dtype))
            loaded.add(name)
    missing = sorted(set(params) - loaded)
    if missing:
        raise KeyError(f"parameters absent from the reference: {missing}")
    return model
