"""Qwen1.5-110B: dense GQA with QKV bias. [hf:Qwen/Qwen1.5; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=49152, vocab_size=152_064,
    block_pattern=("global",), qkv_bias=True,
    mlp_act="silu_glu", rope_theta=1e6, source="hf:Qwen/Qwen1.5-110B",
)
