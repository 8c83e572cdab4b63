"""Pixtral-12B: mistral-nemo backbone + vision stub (precomputed patch
embeddings replace the first n_patches positions).
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=131_072,
    block_pattern=("global",),
    mlp_act="silu_glu", rope_theta=1e6,
    frontend="vision_stub", n_patches=256,
    source="hf:mistralai/Pixtral-12B-2409",
)
