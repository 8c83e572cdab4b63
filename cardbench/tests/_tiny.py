"""Tiny cells of the benchmark's two configurations for CPU tests."""
import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import cell_run, manifest  # noqa: E402

CONFIGS = {"dense": "yi-34b-x30", "moe": "mixtral-8x7b-x16"}
LIMITS = "yi-34b-x30.azure-code"     # the cell whose limits the tiny cells take


def config(family: str, dtype: str = "bfloat16", window: int = 16) -> dict:
    cfg = copy.deepcopy(manifest.load_json(BENCH / "configs" / f"{CONFIGS[family]}.json"))
    cfg.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=256, torch_dtype=dtype)
    if family == "moe":
        cfg["sliding_window"] = window
    return cfg


def traffic(batch: int = 3, prompt_len: int = 40, output_tokens: int = 7,
            judge_requests: int = 4) -> dict:
    return dict(loop="closed", batch=batch, prompt_len=prompt_len,
                output_tokens=output_tokens, judge_requests=judge_requests)


def cell(family: str, dtype: str = "bfloat16", **tr) -> manifest.Cell:
    """A tiny cell of the family, held to the limits of ``LIMITS``."""
    real = manifest.cell(LIMITS)
    return manifest.Cell(name=f"tiny-{family}", config=config(family, dtype),
                         traffic=traffic(**tr), limits=real.limits, chips=1,
                         end_to_end=real.end_to_end, per_layer=real.per_layer)


def run(c: manifest.Cell, seed: int = 2**31 + 11, seconds: float = 0.3, control=False):
    """One run on the CPU, the harness's look for a card skipped."""
    return cell_run.run(c, seed, seconds, False, time.perf_counter(), torch.device("cpu"),
                        control=control)
