"""What decides ``correct``: served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from ``--seed``, is run through the family's
fp32 reference: each prompt followed by the tokens the program served.
At every served position the number compared is how far the served
token's reference logit lies below the reference's best logit there; the
run's reading is the widest such gap over the sample.  All requests of a
cell have one length, so every sample holds the longest.  The sample is
spread over the rows of a batch: the rows fall into ``min(judge_requests,
batch)`` strata of equal size and each stratum gives its share of the
sample, drawn over every finished batch, so a fault in any half (or other
stratum) of each batch cannot miss the sample.

The control puts the reference, with every product in float8 e4m3, in the
program's place: at the same positions it reads the gap of the token the
float8 logits put first.  The benchmark's runs do not run it;
``calibrate.py`` and the tests do.
"""
from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import manifest
from . import weights as W


def verdict(check: dict, limits: dict) -> bool:
    """``correct``: every number the cell's limits name within its limit."""
    return all(check[name] <= limit for name, limit in limits.items())


def sample(batches: Sequence, traffic: dict, seed: int) -> List[Tuple[int, int]]:
    """(position in ``batches``, row) of the requests to check, each row
    stratum of a batch given ``judge_requests / strata`` of them."""
    B, n = traffic["batch"], traffic["judge_requests"]
    strata = min(n, B)
    rng = random.Random(W.sub_seed(seed, "judge"))
    picks = []
    for s in range(strata):
        rows = range(s * B // strata, (s + 1) * B // strata)
        pool = [(i, r) for i in range(len(batches)) for r in rows]
        picks += rng.sample(pool, min(n // strata + (s < n % strata), len(pool)))
    return sorted(picks)


def check(cfg: dict, traffic: dict, seed: int, batches: Sequence, device,
          control: bool = False) -> dict:
    """{"logit_gap": widest gap, "served": tokens compared, "mismatches":
    served tokens that are not the reference's first, "mismatch_share":
    their share, "dropped": capacity drops the reference made[,
    "control_logit_gap", "control_mismatch_share": the control's]}."""
    ref = manifest.reference(cfg["family"])
    from reference import setup_fp32
    setup_fp32()
    picks = sample(batches, traffic, seed)
    requests, served = [], []
    for i, row in picks:
        b = batches[i]
        prompt = W.prompts(cfg, traffic, seed, b.index, device)[row]
        toks = torch.as_tensor(np.ascontiguousarray(b.tokens[row]), device=device)
        requests.append((torch.cat([prompt, toks[:-1]]), prompt.numel()))
        served.append(toks)

    def draw(group):
        return W.draw_group(cfg, seed, group, device)

    dropped0 = getattr(getattr(ref, "experts", None), "dropped", 0)
    out = dict(logit_gap=0.0, served=0, mismatches=0)
    best = []
    for lg, toks in zip(ref.logits(cfg, draw, requests), served):
        top = lg.max(dim=-1).values
        gaps = top - lg.gather(1, toks[:, None])[:, 0]
        out["logit_gap"] = max(out["logit_gap"], float(gaps.max()))
        out["served"] += toks.numel()
        out["mismatches"] += int((gaps > 0).sum())
        best.append((lg, top))
    out["mismatch_share"] = out["mismatches"] / out["served"]
    if hasattr(ref, "experts"):
        out["dropped"] = ref.experts.dropped - dropped0
    if control:
        gap, missed = 0.0, 0
        for (lg, top), ctl in zip(best, ref.logits(cfg, draw, requests, precision="fp8")):
            gaps = top - lg.gather(1, ctl.argmax(dim=-1)[:, None])[:, 0]
            gap = max(gap, float(gaps.max()))
            missed += int((gaps > 0).sum())
        out["control_logit_gap"] = gap
        out["control_mismatch_share"] = missed / out["served"]
    return out
