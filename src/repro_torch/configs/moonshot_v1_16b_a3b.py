"""Moonshot/Moonlight-16B-A3B: 64-expert top-6 fine-grained MoE.
[hf:moonshotai/Moonlight-16B-A3B; hf]  (first-layer-dense detail of the HF
checkpoint is not modelled; every layer is MoE per the assignment spec)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=163_840,
    block_pattern=("moe_global",),
    mlp_act="silu_glu", n_experts=64, top_k=6,
    # NOTE: expert_parallel=True was tried and REFUTED for this cell — under
    # pjit/GSPMD the dispatch tensor replicates its batch dim (all-to-all of
    # the full (B,E,C,d) buffer) instead of routing token subsets; see
    # EXPERIMENTS.md §Perf.  Proper EP needs a shard_map dispatch.
    param_dtype="bfloat16",  # mixed precision (fp32 master in optimizer)
    rope_theta=50_000.0, source="hf:moonshotai/Moonlight-16B-A3B",
)
