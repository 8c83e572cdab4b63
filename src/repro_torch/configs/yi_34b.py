"""Yi-34B: llama-architecture dense GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab_size=64_000,
    block_pattern=("global",),
    mlp_act="silu_glu", rope_theta=5e6, source="arXiv:2403.04652",
    pad_heads=64,   # kept for config parity with the JAX package; the port's
                    # attention never pads heads (zero heads change no output)
)
