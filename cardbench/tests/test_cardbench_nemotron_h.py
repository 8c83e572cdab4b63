"""The hybrid Mamba-2 family (Nemotron-H) on the CPU at a tiny size: its
plain reference against the port's plain path in fp32 (prefill, then every
decode step through the cache), the float8 control against the bf16
program, the planted faults, and K4's closed form and metric readers."""
import copy
import math
import time

import pytest
import torch

import _tiny
from harness import cell_run, faults, judge, manifest, program
from harness import weights as W
from harness.peaks import bound, peaks

SEED = 2**31 + 7
CELL = "nemotron-h-47b-x49.azure-conv-b32"
CONFIG = "nemotron-h-47b-x49"


def config(dtype: str = "bfloat16") -> dict:
    """The configuration at tiny widths: every layer kind, a ragged last
    chunk (prompts of 40 in chunks of 16), heads in two groups."""
    cfg = copy.deepcopy(manifest.load_json(_tiny.BENCH / "configs" / f"{CONFIG}.json"))
    cfg.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=2, attention_head_dim=16, mamba_num_heads=4,
               mamba_head_dim=16, expand=1, n_groups=2, ssm_state_size=16, chunk_size=16,
               vocab_size=256, hybrid_override_pattern="M-*M-", num_hidden_layers=5,
               torch_dtype=dtype)
    return cfg


def cell(**tr) -> manifest.Cell:
    real = manifest.cell(CELL)
    return manifest.Cell(name="tiny-nemotron-h", config=config(), traffic=_tiny.traffic(**tr),
                         limits=real.limits, chips=1, end_to_end=real.end_to_end,
                         per_layer=real.per_layer)


def run(c: manifest.Cell, control: bool = False):
    return cell_run.run(c, SEED, 0.3, False, time.perf_counter(), torch.device("cpu"),
                        control=control)


def test_reference_matches_the_port_in_fp32():
    cfg = config("float32")
    tr = _tiny.traffic(batch=2, prompt_len=40, output_tokens=5)
    prompts = W.prompts(cfg, tr, SEED, 0, "cpu")
    served = torch.randint(0, cfg["vocab_size"], (2, 6),
                           generator=torch.Generator().manual_seed(0))
    model = program.build_model(cfg, SEED, torch.device("cpu"))
    out, cache = model.prefill(prompts, 40 + 6)
    rows = [out[:, -1]]
    for i in range(5):
        lg, cache = model.decode_step(served[:, i:i + 1], 40 + i, cache)
        rows.append(lg[:, 0])
    want = torch.stack(rows, dim=1)
    got = manifest.reference("nemotron_h").logits(
        cfg, lambda g: W.draw_group(cfg, SEED, g, "cpu"),
        [(torch.cat([prompts[b], served[b, :-1]]), 40) for b in range(2)])
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=1e-4, atol=1e-4)


def test_control_reads_wider_than_the_program():
    out = run(cell(output_tokens=9, judge_requests=6), control=True)
    check = out["check"]
    assert check["served"] == 6 * 9
    assert check["control_logit_gap"] > check["logit_gap"]


def test_sound_run_is_correct():
    c = cell(batch=4, output_tokens=9, judge_requests=8)
    out = run(c)
    assert judge.verdict(out["check"], c.limits), out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 4


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    c = cell(batch=4, output_tokens=9, judge_requests=8)
    with faults.planted(fault):
        out = run(c)
    assert not judge.verdict(out["check"], c.limits), out["check"]


def test_k4_work_at_the_cells_shape():
    """One state update at batch 32: 4 operations a state element; the
    fp32 state read and written, x, B, C (fp32) read and y written once,
    dt, dt_bias, A_log and D read once in bf16."""
    fam = manifest.family("nemotron_h")
    cfg = manifest.cell(CELL).config
    ops, nbytes = fam.k4_work(cfg, 32)
    state = 32 * 256 * 64 * 256
    assert ops == 4 * state
    assert nbytes == 4 * (2 * state + 32 * (16384 + 2 * 8 * 256) + 32 * 16384) \
        + 2 * (32 * 256 + 3 * 256)
    ms, what = bound(ops, nbytes, *peaks("NVIDIA H100 80GB HBM3")[1][1:])
    assert what == "bytes" and ms == pytest.approx(0.3219, abs=1e-4)


def test_k4_readers_on_a_synthetic_trace():
    read = {n: manifest.metric_reader(n) for n in ("k4_roofline", "ssm.state_update_ms")}
    cfg = manifest.cell(CELL).config
    bf16, fp32, bw = peaks("NVIDIA H100 80GB HBM3")[1]
    least = bound(*manifest.family("nemotron_h").k4_work(cfg, 32), fp32, bw)[0]
    kernels = [("void (anonymous namespace)::ssm_state_update_kernel<2>(float*)", 0.0, 0.002),
               ("nvjet_tst_64x8", 0.002, 0.003),
               ("void (anonymous namespace)::ssm_state_update_kernel<2>(float*)", 0.003, 0.005)]
    rec = dict(cfg=cfg, batch_size=32, bf16_peak=bf16, kernels=kernels,
               batches=[dict(decode_ms=[1.0] * 4)])
    assert read["k4_roofline"](rec) == pytest.approx(100.0 * 2 * least / 4.0)
    assert read["ssm.state_update_ms"](rec) == pytest.approx(4.0 / 4)
    quiet = dict(rec, kernels=kernels[1:2])
    assert read["k4_roofline"](quiet) is None and read["ssm.state_update_ms"](quiet) is None


def test_the_cut_keeps_every_published_width():
    cfg = manifest.cell(CELL).config
    assert cfg["hybrid_override_pattern"] == cfg["published"]["hybrid_override_pattern"][49:]
    kinds = manifest.family("nemotron_h").kinds(cfg)
    assert (kinds.count("mamba2"), kinds.count("mlp"), kinds.count("attn")) == (21, 25, 3)
    n = manifest.family("nemotron_h").dims(cfg)
    assert (n["d"], n["di"], n["conv"], n["H"], n["P"], n["G"], n["N"]) == \
        (8192, 16384, 20480, 256, 64, 8, 256)
    params = sum(math.prod(s) for g in manifest.family("nemotron_h").group_names(cfg)
                 for _, s, _ in manifest.family("nemotron_h").group_specs(cfg, g))
    assert params == pytest.approx(24.39e9, rel=1e-3)


def test_port_config_holds_the_stated_state_dtype():
    """The check's readings do not tell a bf16 SSM state from an fp32 one
    at the cell (PERF.md §4), so the family refuses a program whose cache
    keeps the state in another dtype than the configuration states."""
    family = manifest.family("nemotron_h")
    cfg = config()
    assert family.port_config(cfg).ssm_state == 16
    cfg["assumed"]["ssm_state_dtype"] = "bfloat16"
    with pytest.raises(ValueError, match="SSM state in torch.float32"):
        family.port_config(cfg)
