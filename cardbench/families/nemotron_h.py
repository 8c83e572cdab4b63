"""The hybrid Mamba-2 stack (Nemotron-H): weights, work, the port's config.

Layer i is the kind ``hybrid_override_pattern[i]`` names (``M`` Mamba-2,
``-`` the squared-ReLU MLP, ``*`` GQA attention), each ``h + mixer(
RMSNorm(h))``.  Weight names are the port's (``layers.<i>.ln1.scale``,
``layers.<i>.mamba.in_proj.w``, ``layers.<i>.attn.wq.w``,
``layers.<i>.mlp.wi.w``, ...), a product's weight stored (d_in, d_out);
groups are the embedding, each layer, and the head.  Standard deviations
come from the configuration's ``init``: zero-mean draws, so ``A_log`` and
``dt_bias`` take stds that spread the heads' per-step decay exp(dt A).

Model FLOPs count what the tokens need: 2 x the matmul parameters a token
passes through, the output head once per served token, 4 x heads x
d_head per attended (query, key) pair in the attention layers, and the
recurrence's 4 x H x P x N per token in a Mamba-2 layer (decay, the outer
product's add, the read-out's multiply-add on every state element).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from .dense import Spec, attended_pairs

KIND_OF = {"M": "mamba2", "-": "mlp", "*": "attn"}


def dims(cfg: dict) -> dict:
    H, P, G, N = (cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"],
                  cfg["ssm_state_size"])
    return dict(d=cfg["hidden_size"], f=cfg["intermediate_size"],
                Hq=cfg["num_attention_heads"], K=cfg["num_key_value_heads"],
                dh=cfg["attention_head_dim"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"], H=H, P=P, G=G, N=N, di=H * P,
                conv=H * P + 2 * G * N, taps=cfg["conv_kernel"])


def kinds(cfg: dict) -> List[str]:
    pattern = cfg["hybrid_override_pattern"]
    if len(pattern) != cfg["num_hidden_layers"]:
        raise ValueError(f"the pattern has {len(pattern)} layers, "
                         f"num_hidden_layers {cfg['num_hidden_layers']}")
    return [KIND_OF[c] for c in pattern]


def group_names(cfg: dict) -> List[str]:
    return ["embed"] + [f"layers.{i}" for i in range(cfg["num_hidden_layers"])] + ["head"]


def group_specs(cfg: dict, group: str) -> List[Spec]:
    """(name, shape, standard deviation) of every tensor of ``group``."""
    n = dims(cfg)
    d, V = n["d"], n["V"]
    init = cfg["init"]
    norm = init["norm_std"]
    if group == "embed":
        return [("embed.table", (V, d), init["embed_std_x_sqrt_d"] / math.sqrt(d))]
    if group == "head":
        return [("final_norm.scale", (d,), norm), ("logits.w", (d, V), 1 / math.sqrt(d))]
    p = group + "."
    kind = kinds(cfg)[int(group.split(".")[1])]
    out = [(p + "ln1.scale", (d,), norm)]
    if kind == "mamba2":
        H, di, conv, taps = n["H"], n["di"], n["conv"], n["taps"]
        m = p + "mamba."
        return out + [(m + "in_proj.w", (d, di + conv + H), 1 / math.sqrt(d)),
                      (m + "conv_w", (conv, taps), 1 / math.sqrt(taps)),
                      (m + "conv_b", (conv,), init["conv_b_std"]),
                      (m + "dt_bias", (H,), init["dt_bias_std"]),
                      (m + "A_log", (H,), init["a_log_std"]),
                      (m + "D", (H,), init["d_std"]),
                      (m + "norm.scale", (di,), norm),
                      (m + "out_proj.w", (di, d), 1 / math.sqrt(di))]
    if kind == "attn":
        Hq, K, dh = n["Hq"], n["K"], n["dh"]
        qk = init["qk_gain"] / math.sqrt(d)
        return out + [(p + "attn.wq.w", (d, Hq * dh), qk), (p + "attn.wk.w", (d, K * dh), qk),
                      (p + "attn.wv.w", (d, K * dh), 1 / math.sqrt(d)),
                      (p + "attn.wo.w", (Hq * dh, d), 1 / math.sqrt(Hq * dh))]
    f = n["f"]
    return out + [(p + "mlp.wi.w", (d, f), 1 / math.sqrt(d)),
                  (p + "mlp.wo.w", (f, d), 1 / math.sqrt(f))]


def layer_matmul_params(cfg: dict, kind: str) -> int:
    n = dims(cfg)
    d = n["d"]
    if kind == "mamba2":
        return d * (n["di"] + n["conv"] + n["H"]) + n["di"] * d
    if kind == "attn":
        return 2 * d * n["Hq"] * n["dh"] + 2 * d * n["K"] * n["dh"]
    return 2 * d * n["f"]


def _per_token(cfg: dict) -> float:
    """FLOPs of one token through every layer, attention pairs aside."""
    n = dims(cfg)
    state = 4 * n["H"] * n["P"] * n["N"]
    return sum(2 * layer_matmul_params(cfg, k) + (state if k == "mamba2" else 0)
               for k in kinds(cfg))


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    n = dims(cfg)
    attn = kinds(cfg).count("attn") * 4 * n["Hq"] * n["dh"] * attended_pairs(cfg, 0, seq)
    return batch * (_per_token(cfg) * seq + attn + 2 * n["d"] * n["V"])


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    """One decode step of ``batch`` requests, each token at ``pos``."""
    n = dims(cfg)
    attn = kinds(cfg).count("attn") * 4 * n["Hq"] * n["dh"] * attended_pairs(cfg, pos, pos + 1)
    return batch * (_per_token(cfg) + attn + 2 * n["d"] * n["V"])


def k1_work(cfg: dict, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one K1 launch over a prefill of ``batch`` x
    ``seq``: the causal pairs' QK^T and PV, and q, k, v read and o written
    once in bf16."""
    n = dims(cfg)
    Hq, K, dh = n["Hq"], n["K"], n["dh"]
    return (4 * batch * Hq * dh * attended_pairs(cfg, 0, seq),
            2 * batch * seq * dh * (2 * Hq + 2 * K))


def k4_work(cfg: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of the state update of one K4 call (the kernel
    bearing K4's mark), one Mamba-2 layer's decode step of ``batch``
    requests: 4 operations on every state element (decay, the outer
    product's add, the read-out's multiply-add); the fp32 state read and
    written once, x, B and C (the conv step's fp32 output) read once, dt
    and the layer's dt_bias, A_log and D read once in the served dtype, y
    written once in fp32."""
    n = dims(cfg)
    H, P, G, N = n["H"], n["P"], n["G"], n["N"]
    state = batch * H * P * N
    item = 2 if cfg["torch_dtype"] == "bfloat16" else 4
    nbytes = 4 * (2 * state + batch * (2 * H * P + 2 * G * N)) + item * (batch * H + 3 * H)
    return 4 * state, nbytes


def port_config(cfg: dict):
    """The port's HybridConfig of ``cfg``: its architecture's, at the
    configuration's depth, pattern, sizes and dtype; raises where the
    port computes something the configuration does not state, the SSM
    state's dtype included (the check's readings cannot tell a bf16 state
    from an fp32 one at this cell, PERF.md §4)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_cache_shape
    n = dims(cfg)
    if cfg["expand"] * n["d"] != n["di"]:
        raise ValueError("expand x hidden_size is not mamba_num_heads x mamba_head_dim")
    stated = dict(mamba_hidden_act="silu", mlp_hidden_act="relu2", attention_bias=False,
                  mamba_proj_bias=False, mlp_bias=False, use_conv_bias=True,
                  time_step_limit=[0, None], sliding_window=None, tie_word_embeddings=False)
    bad = {k: cfg[k] for k, v in stated.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the port's nemotron-h computes no {bad}")
    pc = dataclasses.replace(
        get_config(cfg["arch"]), n_layers=n["L"], block_pattern=tuple(kinds(cfg)),
        d_model=n["d"], d_ff=n["f"], n_heads=n["Hq"], n_kv_heads=n["K"], d_head=n["dh"],
        vocab_size=n["V"], ssm_heads=n["H"], ssm_head_dim=n["P"], ssm_groups=n["G"],
        ssm_state=n["N"], ssm_chunk=cfg["chunk_size"], conv_width=n["taps"],
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"])
    want = dict(norm="rmsnorm", mlp_act="sq_relu", tie_embeddings=False, use_rope=False,
                qkv_bias=False, post_norm=False, window=0,
                logit_softcap=0.0, attn_softcap=0.0, query_scale=None, is_encdec=False,
                frontend="none", layer_kinds=tuple(kinds(cfg)))
    bad = {k: getattr(pc, k) for k, v in want.items() if getattr(pc, k) != v}
    if bad:
        raise ValueError(f"the port's {cfg['arch']} computes {bad}, which "
                         f"{cfg['name']} does not state")
    state = layer_cache_shape(pc, "mamba2", 1, 1)["ssm"][1]
    stated = cfg["assumed"]["ssm_state_dtype"]
    if state != getattr(torch, stated):
        raise ValueError(f"the port keeps the SSM state in {state}; {cfg['name']} "
                         f"states {stated}")
    return pc
