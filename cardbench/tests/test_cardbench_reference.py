"""The plain reference against the port's plain path, on the benchmark's own
weights, at a tiny size on the CPU: prefill's last position and every decode
step through the cache, both families, capacity drops included."""
import pytest
import torch

import _tiny
from harness import manifest, program
from harness import weights as W

SEED = 2**31 + 5


def port_logits(cfg, prompts, served):
    """The port's logits at the prefill's last position and after each served
    token but the last, as the timed path computes them (plain forms on the
    CPU)."""
    model = program.build_model(cfg, SEED, torch.device("cpu"))
    B, S = prompts.shape
    out, cache = model.prefill(prompts, S + served.shape[1])
    rows = [out[:, -1]]
    for i in range(served.shape[1] - 1):
        lg, cache = model.decode_step(served[:, i:i + 1], S + i, cache)
        rows.append(lg[:, 0])
    return torch.stack(rows, dim=1)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_matches_the_port_in_fp32(family):
    torch.manual_seed(0)
    cfg = _tiny.config(family, "float32")
    tr = _tiny.traffic(batch=2, prompt_len=48, output_tokens=5)
    prompts = W.prompts(cfg, tr, SEED, 0, "cpu")
    served = torch.randint(0, cfg["vocab_size"], (2, 6))
    want = port_logits(cfg, prompts, served)
    ref = manifest.reference(family)
    before = getattr(getattr(ref, "experts", None), "dropped", 0)
    got = ref.logits(cfg, lambda g: W.draw_group(cfg, SEED, g, "cpu"),
                     [(torch.cat([prompts[b], served[b, :-1]]), 48) for b in range(2)])
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=1e-4, atol=1e-4)
    if family == "moe":
        assert ref.experts.dropped - before > 0, "no capacity drop exercised"


def test_window_band_is_exercised():
    """mixtral's window (16 here) is shorter than the prompt, so keys fall out."""
    cfg = _tiny.config("moe", "float32", window=16)
    tr = _tiny.traffic(batch=1, prompt_len=48, output_tokens=3)
    prompts = W.prompts(cfg, tr, SEED, 0, "cpu")
    served = torch.randint(0, cfg["vocab_size"], (1, 4))
    want = port_logits(cfg, prompts, served)
    wide = dict(cfg, sliding_window=0)
    got = manifest.reference("moe").logits(
        wide, lambda g: W.draw_group(cfg, SEED, g, "cpu"),
        [(torch.cat([prompts[0], served[0, :-1]]), 48)])
    assert (got[0] - want[0]).abs().max() > 1e-3


def test_weights_are_drawn_alike_and_by_seed():
    cfg = _tiny.config("moe")
    a = W.draw_group(cfg, SEED, "layers.1", "cpu")
    b = W.draw_group(cfg, SEED, "layers.1", "cpu")
    c = W.draw_group(cfg, SEED + 1, "layers.1", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.1.moe.wi"], c["layers.1.moe.wi"])
    assert a["layers.1.moe.wi"].dtype == torch.bfloat16
    big = W.sub_seed(2**40 + 3, "embed")
    assert 0 <= big < 2**63


def test_control_reads_wider_than_the_program():
    """The float8 control against the bf16 program, both judged by the fp32
    reference, on a tiny yi: the control's widest gap is the wider."""
    c = _tiny.cell("dense", output_tokens=9, judge_requests=6)
    out = _tiny.run(c, seed=2**31 + 21, control=True)
    check = out["check"]
    assert check["served"] == 6 * 9
    assert check["control_logit_gap"] > check["logit_gap"]
    assert check["control_mismatch_share"] > check["mismatch_share"]
