"""Yi-34B: llama-architecture dense GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab_size=64_000,
    block_pattern=("global",),
    mlp_act="silu_glu", rope_theta=5e6, source="arXiv:2403.04652",
    pad_heads=64,   # 56 heads don't divide the 16-way model axis: inside a
                    # sharding context (the dry-run) attention pads them to
                    # 64 as the reference's does; outside one it never pads
                    # (zero heads change no output)
)
