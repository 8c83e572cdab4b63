"""BENCHMARK.json against the contract, and every name resolved to its file."""
import ast
import json
import math
import re

import pytest

from _tiny import BENCH
from harness import manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads",
          "head_dim", "num_experts_per_tok", "vocab_size")


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["cardbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    assert len(json.dumps(MAN)) < 64 * 1024


def test_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    c = manifest.cell(w["name"])
    assert w["chips"] == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], w["name"])
    assert c.limits and set(c.limits) <= {"logit_gap", "mismatch_share"}
    assert all(limit > 0 for limit in c.limits.values())
    for key in ("batch", "prompt_len", "output_tokens", "judge_requests"):
        assert c.traffic[key] >= 1
    assert c.traffic["prompt_len"] + c.traffic["output_tokens"] \
        <= c.config["max_position_embeddings"]


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = manifest.load_json(BENCH.parent / entry["file"])
    assert entry["file"].startswith("cardbench/configs/")
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["source"].startswith(entry["source"])
    for key in entry["reduced"]:
        assert key in cfg["published"] and key not in WIDTHS
        assert not key.endswith(("_dim", "_rank"))
    assert cfg["hidden_size"] % cfg["num_attention_heads"] == 0
    assert manifest.reference(cfg["family"]).logits
    fam = manifest.family(cfg["family"])
    for fn in ("group_names", "group_specs", "prefill_flops", "decode_flops", "k1_work",
               "port_config"):
        assert callable(getattr(fam, fn)), fn


def test_the_harness_holds_no_family_branch():
    """What belongs to one family sits in ``families/`` and ``reference/``,
    found by the configuration's ``family``; the shared harness names none."""
    families = {p.stem for p in (BENCH / "families").glob("*.py")} - {"__init__"}
    assert {"dense", "moe"} <= families
    for path in [*(BENCH / "harness").glob("*.py"), BENCH / "run.py"]:
        strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert not strings & families, path.name


def test_every_metric_has_a_reader_and_a_layer():
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["layer"] and "\n" not in m["layer"]
        assert "roofline" not in m["name"] or m["name"].endswith("_roofline")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_time_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert math.isfinite(MAN["run_seconds"])
