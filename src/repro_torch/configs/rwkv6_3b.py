"""RWKV-6 'Finch' 3B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
    d_ff=8960, vocab_size=65_536,
    block_pattern=("rwkv",), norm="layernorm",
    use_rope=False, source="arXiv:2404.05892",
)
