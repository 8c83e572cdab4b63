"""Mixtral 8x7B: 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=32_000,
    block_pattern=("moe_local",), window=4096,
    mlp_act="silu_glu", n_experts=8, top_k=2,
    rope_theta=1e6, source="arXiv:2401.04088",
    param_dtype="bfloat16",  # mixed precision: bf16 weights + fp32 master in
                             # the optimizer (§Perf hillclimb: halves weight
                             # gather / read traffic)
)
