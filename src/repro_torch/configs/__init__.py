"""Architecture registry of the port: all ten architectures of the JAX
package.  Mirrors ``get_config`` / ``reduced_config`` of its registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x7b": "mixtral_8x7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen1.5-110b": "qwen15_110b",
    "gemma2-27b": "gemma2_27b",
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-34b": "yi_34b",
    "rwkv6-3b": "rwkv6_3b",
    "pixtral-12b": "pixtral_12b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"choose from {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCH_MODULES)


def reduced_config(name: str, **overrides) -> ModelConfig:
    """CPU-sized config of the same family for smoke tests: same block
    pattern and features, tiny dims."""
    cfg = get_config(name)
    unit = len(cfg.block_pattern)
    small = dict(
        n_layers=max(2 * unit, unit + 1) if unit > 1 else 2,
        d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_head=16, d_ff=128, vocab_size=256,
        rnn_width=64 if cfg.rnn_width else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=24 if cfg.encoder_seq else 0,
        n_patches=8 if cfg.n_patches else 0,
    )
    if cfg.name == "rwkv6-3b":
        small.update(n_heads=1, n_kv_heads=1, d_model=64, d_head=64)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
