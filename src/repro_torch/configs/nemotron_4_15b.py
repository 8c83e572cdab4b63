"""Nemotron-4 15B: dense GQA with squared-ReLU MLP and LayerNorm.
[arXiv:2402.16819; unverified]  (partial-rotary detail approximated with
full RoPE; noted in DESIGN.md)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=256_000,
    block_pattern=("global",),
    mlp_act="sq_relu", norm="layernorm", source="arXiv:2402.16819",
)
