"""Gemma-2 27B: alternating local/global attention, logit softcaps,
sandwich norms. [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab_size=256_000,
    block_pattern=("local", "global"), window=4096,
    mlp_act="gelu_glu", attn_softcap=50.0, logit_softcap=30.0,
    post_norm=True, tie_embeddings=True,
    query_scale=144.0 ** -0.5,  # query_pre_attn_scalar = d_model / n_heads
    source="arXiv:2408.00118",
)
