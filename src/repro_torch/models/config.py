"""Model configuration for the assigned architecture pool.

A single config dataclass covers dense / MoE / hybrid (RG-LRU) / SSM (RWKV6)
/ enc-dec (whisper) / VLM-stub (pixtral) families.  Layer structure is a
repeating ``block_pattern`` unit (e.g. Griffin's (rec, rec, attn), Gemma-2's
(local, global)); leftover layers replay a truncated unit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

BLOCK_KINDS = ("global", "local", "moe_global", "moe_local", "rec", "rwkv")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("global",)

    # attention details
    window: int = 0                 # sliding/local attention window
    logit_softcap: float = 0.0      # final-logit softcap (gemma2: 30)
    attn_softcap: float = 0.0       # attention-logit softcap (gemma2: 50)
    qkv_bias: bool = False          # qwen
    rope_theta: float = 10_000.0
    use_rope: bool = True           # whisper uses sinusoidal abs pos instead
    post_norm: bool = False         # gemma2 sandwich norms
    query_scale: Optional[float] = None  # override 1/sqrt(d_head)
    pad_heads: int = 0              # pad attention heads to this count inside
                                    # mha (zero heads, sliced off before the
                                    # out-projection) so the head dim divides
                                    # the model axis — yi-34b: 56 -> 64

    # mlp
    mlp_act: str = "silu_glu"       # silu_glu | gelu_glu | sq_relu | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_parallel: bool = False   # shard experts over 'data' (EP): tokens
                                    # all-to-all to experts instead of
                                    # gathering expert weights every layer

    # recurrent (RG-LRU / RWKV6)
    rnn_width: int = 0
    conv_width: int = 4             # temporal-conv taps in the Griffin block

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0            # fixed encoder length from the conv stub

    # frontends (stubs per assignment spec)
    frontend: str = "none"          # none | audio_stub | vision_stub
    n_patches: int = 0              # vision stub: patch-embedding positions

    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # citation / provenance (from the assignment table)
    source: str = ""

    def __post_init__(self):
        for kind in self.block_pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # -- derived -----------------------------------------------------------
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, pattern repeated/truncated to n_layers."""
        unit = self.block_pattern
        reps = math.ceil(self.n_layers / len(unit))
        return tuple((unit * reps)[: self.n_layers])

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """True when no layer does full-context attention over the whole
        sequence (bounded-window or recurrent layers only)."""
        return all(k in ("local", "moe_local", "rec", "rwkv")
                   for k in self.layer_kinds)

    @property
    def supports_long_context(self) -> bool:
        """Eligibility for the long_500k cell: sub-quadratic, or mixed
        local/global where the KV memory is shardable (gemma2-style).
        Pure full-attention stacks and the audio enc-dec are skipped
        (see DESIGN.md §Arch-applicability)."""
        if self.is_encdec:
            return False
        kinds = set(self.layer_kinds)
        if kinds <= {"local", "moe_local", "rec", "rwkv"}:
            return True
        # alternating local/global (gemma2, recurrentgemma) still qualifies
        return ("local" in kinds or "rec" in kinds or "rwkv" in kinds)

    def active_params(self) -> int:
        """Approximate active parameter count (per-token) — used for the
        MODEL_FLOPS = 6*N*D roofline term (MoE: only routed-in experts)."""
        d, dh = self.d_model, self.d_head
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.layer_kinds:
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
            glu = self.mlp_act.endswith("_glu")
            ffn_one = d * self.d_ff * (3 if glu else 2)
            if kind in ("moe_global", "moe_local"):
                ffn = self.top_k * ffn_one + d * self.n_experts  # + router
                total += attn + ffn
            elif kind == "rec":
                # griffin recurrent block: 2 in-proj, out-proj, conv, lru gates
                rw = self.rnn_width or d
                total += 2 * d * rw + rw * d + self.conv_width * rw + 2 * rw * rw // 8 \
                    + ffn_one
            elif kind == "rwkv":
                # time-mix (r,k,v,g,o) + channel-mix
                total += 5 * d * d + d * self.d_ff + self.d_ff * d
            else:
                total += attn + ffn_one
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder already counted above
            attn = 2 * (d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                        + self.n_heads * dh * d)
            total += self.encoder_layers * (attn // 2 + 2 * d * self.d_ff)
        return int(total)

    def total_params(self) -> int:
        """Total parameter count (MoE: all experts)."""
        if self.n_experts:
            per_tok = self.active_params()
            glu = self.mlp_act.endswith("_glu")
            ffn_one = self.d_model * self.d_ff * (3 if glu else 2)
            n_moe = sum(1 for k in self.layer_kinds if k.startswith("moe"))
            return per_tok + n_moe * (self.n_experts - self.top_k) * ffn_one
        return self.active_params()
