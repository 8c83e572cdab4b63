"""Architecture + shape registry of the port: all ten architectures of the
JAX package and its four input shapes (10 archs x 4 shapes).  Mirrors its
registry: ``Shape``, ``SHAPES``, ``TRAIN_MICROBATCHES``, ``cell_status`` and
``all_cells`` keep the reference's text, ``get_config`` /
``reduced_config`` its behaviour.

Each cell pairs an architecture with an input shape; ``mode`` selects which
step gets counted (train_step / prefill / serve_step, ``launch.dryrun``).
``long_500k`` runs only for sub-quadratic-capable archs; skipped cells
carry an explanatory reason and still appear in reports.

``PORT_ONLY`` names the configurations of the port alone (a model the JAX
package does not have: nemotron-h-47b's Mamba-2 layers); ``get_config``
finds them too, but they are no architecture of the registry:
``list_archs`` and ``all_cells`` keep the reference's ten.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

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

PORT_ONLY = {
    "nemotron-h-47b": "nemotron_h_47b",
}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# gradient-accumulation microbatches per (arch, shape) — memory-fit knobs;
# everything absent defaults to 1.
TRAIN_MICROBATCHES: Dict[Tuple[str, str], int] = {
    ("qwen1.5-110b", "train_4k"): 4,
    ("yi-34b", "train_4k"): 4,
    ("gemma2-27b", "train_4k"): 2,
    ("nemotron-4-15b", "train_4k"): 2,
    ("whisper-large-v3", "train_4k"): 2,
    ("mixtral-8x7b", "train_4k"): 2,
    ("moonshot-v1-16b-a3b", "train_4k"): 2,
    ("pixtral-12b", "train_4k"): 2,
    ("rwkv6-3b", "train_4k"): 2,
    ("recurrentgemma-9b", "train_4k"): 2,
}


def get_config(name: str) -> ModelConfig:
    module = ARCH_MODULES.get(name) or PORT_ONLY.get(name)
    if module is None:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"choose from {sorted(ARCH_MODULES)} or {sorted(PORT_ONLY)}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCH_MODULES)


def cell_status(cfg: ModelConfig, shape: Shape) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason."""
    if shape.name == "long_500k":
        if cfg.is_encdec:
            return ("skip: enc-dec audio backbone; context is 1500 frames "
                    "by construction (DESIGN.md §Arch-applicability)")
        if not cfg.supports_long_context:
            return ("skip: pure full-attention arch; long_500k requires "
                    "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return None


def all_cells():
    """Yield (arch_name, shape, skip_reason_or_None)."""
    for arch in ARCH_MODULES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            yield arch, shape, cell_status(cfg, shape)


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
