"""The dense decoder (Yi-34B, Llama-style): weights, work, the port's config.

Weight names and layouts are the port's parameter names (``embed.table``,
``layers.<i>.attn.wq.w``, ...) with the weights of a product stored
(d_in, d_out); groups are the embedding, each layer, and the head (final
norm and output projection).  Standard deviations come from the
configuration's ``init``.

Model FLOPs count what the tokens need: 2 x the matmul parameters a token
passes through per token, the output head once per served token (a
prefill takes logits at its last position only), and 4 x heads x d_head
per attended (query, key) pair for QK^T and PV.  Keys a kernel masks are
not counted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

Spec = Tuple[str, Tuple[int, ...], float]          # name, shape, std


def dims(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, f=cfg["intermediate_size"], H=H, K=cfg["num_key_value_heads"],
                dh=d // H, V=cfg["vocab_size"], L=cfg["num_hidden_layers"],
                E=cfg.get("num_local_experts", 0), k=cfg.get("num_experts_per_tok", 0))


def group_names(cfg: dict) -> List[str]:
    return ["embed"] + [f"layers.{i}" for i in range(cfg["num_hidden_layers"])] + ["head"]


def ffn_specs(cfg: dict, p: str) -> List[Spec]:
    n = dims(cfg)
    d, f = n["d"], n["f"]
    return [(p + "mlp.wi.w", (d, f), 1 / math.sqrt(d)),
            (p + "mlp.wg.w", (d, f), 1 / math.sqrt(d)),
            (p + "mlp.wo.w", (f, d), 1 / math.sqrt(f))]


def ffn_params(cfg: dict) -> int:
    """Matmul parameters one token passes through in a layer's feed-forward."""
    n = dims(cfg)
    return 3 * n["d"] * n["f"]


def group_specs(cfg: dict, group: str,
                ffn: Callable[[dict, str], List[Spec]] = ffn_specs) -> List[Spec]:
    """(name, shape, standard deviation) of every tensor of ``group``."""
    n = dims(cfg)
    d, H, K, dh, V = n["d"], n["H"], n["K"], n["dh"], n["V"]
    init = cfg["init"]
    norm = init["norm_std"]
    if group == "embed":
        return [("embed.table", (V, d), init["embed_std_x_sqrt_d"] / math.sqrt(d))]
    if group == "head":
        return [("final_norm.scale", (d,), norm),
                ("logits.w", (d, V), 1 / math.sqrt(d))]
    p = group + "."
    qk = init["qk_gain"] / math.sqrt(d)
    return [(p + "ln1.scale", (d,), norm), (p + "ln2.scale", (d,), norm),
            (p + "attn.wq.w", (d, H * dh), qk), (p + "attn.wk.w", (d, K * dh), qk),
            (p + "attn.wv.w", (d, K * dh), 1 / math.sqrt(d)),
            (p + "attn.wo.w", (H * dh, d), 1 / math.sqrt(H * dh))] + ffn(cfg, p)


def layer_matmul_params(cfg: dict, ffn: Callable[[dict], int] = ffn_params) -> int:
    n = dims(cfg)
    d, H, K, dh = n["d"], n["H"], n["K"], n["dh"]
    return d * H * dh * 2 + d * K * dh * 2 + ffn(cfg)


def attended_pairs(cfg: dict, first: int, last: int) -> int:
    """Unmasked (query, key) pairs of the causal (windowed) queries at
    positions first .. last - 1, summed."""
    w = cfg.get("sliding_window") or 0
    total = 0
    for p in range(first, last):
        total += min(p + 1, w) if w else p + 1
    return total


def prefill_flops(cfg: dict, batch: int, seq: int,
                  ffn: Callable[[dict], int] = ffn_params) -> float:
    n = dims(cfg)
    per_layer = 2 * layer_matmul_params(cfg, ffn) * seq \
        + 4 * n["H"] * n["dh"] * attended_pairs(cfg, 0, seq)
    return batch * (n["L"] * per_layer + 2 * n["d"] * n["V"])


def decode_flops(cfg: dict, batch: int, pos: int,
                 ffn: Callable[[dict], int] = ffn_params) -> float:
    """One decode step of ``batch`` requests, each token at ``pos``."""
    n = dims(cfg)
    per_layer = 2 * layer_matmul_params(cfg, ffn) + 4 * n["H"] * n["dh"] * attended_pairs(
        cfg, pos, pos + 1)
    return batch * (n["L"] * per_layer + 2 * n["d"] * n["V"])


def k1_work(cfg: dict, batch: int, seq: int):
    """(operations, bytes) of one K1 launch over a prefill of ``batch`` x
    ``seq``: the unmasked pairs' QK^T and PV, and q, k, v read and o written
    once in bf16."""
    n = dims(cfg)
    H, K, dh = n["H"], n["K"], n["dh"]
    ops = 4 * batch * H * dh * attended_pairs(cfg, 0, seq)
    nbytes = 2 * batch * seq * dh * (2 * H + 2 * K)
    return ops, nbytes


def port_config(cfg: dict, layer_kind: str = "global", **want_more):
    """The port's ModelConfig of ``cfg``: its architecture's, at the
    configuration's sizes and dtype; raises where the port's architecture
    computes something the configuration does not state."""
    from repro_torch.configs import get_config
    n = dims(cfg)
    pc = dataclasses.replace(
        get_config(cfg["arch"]), n_layers=n["L"], d_model=n["d"], d_ff=n["f"],
        n_heads=n["H"], n_kv_heads=n["K"], d_head=n["dh"], vocab_size=n["V"],
        window=cfg.get("sliding_window") or 0, n_experts=n["E"], top_k=n["k"],
        rope_theta=cfg["rope_theta"], param_dtype=cfg["torch_dtype"],
        compute_dtype=cfg["torch_dtype"])
    want = dict(norm="rmsnorm", mlp_act="silu_glu", tie_embeddings=False, use_rope=True,
                qkv_bias=False, post_norm=False, logit_softcap=0.0, attn_softcap=0.0,
                query_scale=None, is_encdec=False, frontend="none",
                layer_kinds=(layer_kind,) * n["L"], **want_more)
    bad = {k: getattr(pc, k) for k, v in want.items() if getattr(pc, k) != v}
    if bad:
        raise ValueError(f"the port's {cfg['arch']} computes {bad}, which "
                         f"{cfg['name']} does not state")
    return pc
