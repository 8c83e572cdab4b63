"""The sparse-expert decoder (Mixtral 8x7B): the dense family with its
feed-forward replaced by routed experts, stacked (E, d_in, d_out) as the
port names them (``layers.<i>.moe.wi``, ...), and a router.  A token's
feed-forward work is its k experts' and the router's; slots a capacity
buffer holds empty are not counted."""
from __future__ import annotations

import math
from typing import List

from . import dense
from .dense import Spec, dims, group_names, k1_work  # noqa: F401  (the same as dense)


def ffn_specs(cfg: dict, p: str) -> List[Spec]:
    n = dims(cfg)
    d, f, E = n["d"], n["f"], n["E"]
    return [(p + "moe.wi", (E, d, f), 1 / math.sqrt(d)),
            (p + "moe.wg", (E, d, f), 1 / math.sqrt(d)),
            (p + "moe.wo", (E, f, d), 1 / math.sqrt(f)),
            (p + "moe.router.w", (d, E), 1 / math.sqrt(d))]


def ffn_params(cfg: dict) -> int:
    n = dims(cfg)
    return n["k"] * 3 * n["d"] * n["f"] + n["d"] * n["E"]


def group_specs(cfg: dict, group: str) -> List[Spec]:
    return dense.group_specs(cfg, group, ffn_specs)


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    return dense.prefill_flops(cfg, batch, seq, ffn_params)


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    return dense.decode_flops(cfg, batch, pos, ffn_params)


def port_config(cfg: dict):
    kind = "moe_local" if cfg.get("sliding_window") else "moe_global"
    return dense.port_config(cfg, kind, capacity_factor=cfg["assumed"]["capacity_factor"])
