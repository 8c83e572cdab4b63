"""Whisper large-v3: enc-dec transformer backbone; the conv audio frontend
is a stub (the model takes precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab_size=51_866,
    block_pattern=("global",),
    mlp_act="gelu", norm="layernorm", use_rope=False,
    pad_heads=32,   # the reference's mesh padding; applied inside a
                    # sharding context only (the dry-run), as yi-34b's
    encoder_layers=32, encoder_seq=1500,
    frontend="audio_stub", source="arXiv:2212.04356",
)
