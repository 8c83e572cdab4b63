"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 1:2 ratio.
[arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab_size=256_000,
    block_pattern=("rec", "rec", "local"), window=2048,
    mlp_act="gelu_glu", rnn_width=4096, conv_width=4,
    tie_embeddings=True, source="arXiv:2402.19427",
)
