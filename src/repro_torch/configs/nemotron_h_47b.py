"""Nemotron-H-47B-Base-8K: a hybrid of 45 Mamba-2, 48 squared-ReLU MLP and
5 GQA attention layers, each pre-norm with a single mixer.
[hf: nvidia/Nemotron-H-47B-Base-8K config.json; arXiv:2504.03624; Mamba-2:
arXiv:2405.21060]  The published widths and all 98 layers in the
published ``hybrid_override_pattern`` (M Mamba-2, - MLP, * attention); the
attention layers carry no position embedding (the config has no rope
keys).  The port's own configuration: the JAX package has no such model,
so it is found through ``configs.PORT_ONLY``, not ``ARCH_MODULES``."""
from repro_torch.models.mamba2 import HybridConfig

PATTERN = ("M-M-M-M-M-M-M-M-M*-M-M-M-M-M-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*"
           "-M-M-M-M-M-M-M---MM---M-M*-M-M-M-M-M-")
KIND_OF = {"M": "mamba2", "-": "mlp", "*": "attn"}


def kinds(pattern: str):
    """Block kinds of a ``hybrid_override_pattern``."""
    return tuple(KIND_OF[c] for c in pattern)


CONFIG = HybridConfig(
    name="nemotron-h-47b", family="hybrid",
    n_layers=98, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=30720, vocab_size=131_072,
    block_pattern=kinds(PATTERN),
    use_rope=False, mlp_act="sq_relu", conv_width=4,
    ssm_heads=256, ssm_head_dim=64, ssm_groups=8, ssm_state=256, ssm_chunk=128,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:nvidia/Nemotron-H-47B-Base-8K; arXiv:2504.03624",
)
