"""The benchmark's weights: names, shapes and the draw from ``--seed``.

Weights are drawn on the device, in the dtype they are served in
(``torch_dtype`` of the configuration), one ``torch.randn`` call per group:
the family's groups (the embedding, each layer, the head).
A group's tensors are views of that one buffer, each scaled in place by its
standard deviation.  Every group has a generator of its own, seeded from
``--seed`` and the group's name, so the reference can draw one layer again,
alone and bit for bit, after the program's state is freed.

Groups, names, shapes and standard deviations are the family's
(``families/<family>.py``); this module imports nothing of the port.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from .manifest import family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for ``what`` under the run's ``--seed`` (any integer)."""
    digest = hashlib.sha256(f"{seed}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_group(cfg: dict, seed: int, group: str, device) -> Dict[str, torch.Tensor]:
    """The tensors of ``group``, drawn in one call on ``device``."""
    specs = family(cfg["family"]).group_specs(cfg, group)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, group))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=DTYPES[cfg["torch_dtype"]])
    out, at = {}, 0
    for (name, shape, std), size in zip(specs, sizes):
        t = flat[at:at + size].view(shape)
        t.mul_(std)
        at += size
        out[name] = t
    return out


def prompts(cfg: dict, traffic: dict, seed: int, batch_index: int, device) -> torch.Tensor:
    """(batch, prompt_len) token ids, uniform over the vocabulary, for the
    ``batch_index``-th batch (the warm-up batch is -1)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"prompts/{batch_index}"))
    return torch.randint(0, cfg["vocab_size"], (traffic["batch"], traffic["prompt_len"]),
                         generator=gen, device=device)
