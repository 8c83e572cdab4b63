"""The metric readers on synthetic records: tails over all requests, rates
over the whole window, and a stall that moves them; the trace's arithmetic."""
import pytest

import _tiny  # noqa: F401  (puts the harness on the path)
from harness import manifest
from harness.stats import percentile
from harness.trace import busy_and_gaps, clip, idle_by_span

READ = {n: manifest.metric_reader(n) for n in
        ("ttft_p95_ms", "tpot_p95_ms", "out_tok_s", "model.decode_step_ms",
         "device.idle_pct", "k1_roofline", "mfu_pct", "analysis.lag_p95_ms")}


def record(stall_at=None, stall=0.0, batches=10, B=4, N=5, prefill=0.2, step=0.02):
    rec = dict(t0=0.0, t1=2.0, seconds=2.0, batch_size=B, batches=[], lags_ms=[1.0, 3.0],
               bf16_peak=1e12)
    t = 0.0
    for i in range(batches):
        start = t
        t += prefill + (stall if i == stall_at else 0.0)
        toks = [t]
        for _ in range(N):
            t += step
            toks.append(t)
        rec["batches"].append(dict(t_start=start, t_tok=toks, prefill_ms=prefill * 1e3,
                                   decode_ms=[step * 1e3] * N, prefill_flops=1e11,
                                   decode_flops=[1e9] * N))
    return rec


def test_percentile_is_nearest_rank_over_all():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([5.0], 95) == 5.0
    assert percentile([], 95) is None


def test_steady_record():
    rec = record()
    assert READ["ttft_p95_ms"](rec) == pytest.approx(200.0)
    assert READ["tpot_p95_ms"](rec) == pytest.approx(20.0)
    # 6 tokens of 4 requests every 0.3 s: batches 0..6 whole (ends at 2.1 s
    # would cut batch 6 to its tokens before 2.0 s)
    n = sum(1 for b in rec["batches"] for x in b["t_tok"] if x <= 2.0)
    assert READ["out_tok_s"](rec) == pytest.approx(n * 4 / 2.0)
    assert READ["model.decode_step_ms"](rec) == pytest.approx(20.0)
    assert READ["analysis.lag_p95_ms"](rec) == 3.0


def test_a_stall_moves_the_rate_and_the_tail():
    calm, stalled = record(), record(stall_at=1, stall=0.5)
    assert READ["out_tok_s"](stalled) < READ["out_tok_s"](calm)
    assert READ["ttft_p95_ms"](stalled) > READ["ttft_p95_ms"](calm)
    assert READ["mfu_pct"](stalled) < READ["mfu_pct"](calm)


def test_the_tail_is_over_every_request():
    """One slow batch of four requests among five: 4 of 20 requests, more
    than the 5 % above the p95, so the p95 is the slow batch's."""
    rec = record(batches=5, B=4, stall_at=2, stall=0.3)
    assert READ["ttft_p95_ms"](rec) == pytest.approx(500.0)
    rec = record(batches=25, B=4, stall_at=2, stall=0.3)    # 4 of 100: under 5 %
    rec["t1"] = rec["seconds"] = 100.0
    assert READ["ttft_p95_ms"](rec) == pytest.approx(200.0)


def test_trace_arithmetic():
    ks = [("a", 0.0, 1.0), ("flash_fwd_x", 0.5, 1.5), ("b", 3.0, 4.0), ("c", 9.5, 11.0)]
    inside = clip(ks, 0.0, 10.0)
    busy, gaps = busy_and_gaps(inside, 0.0, 10.0)
    assert busy == pytest.approx(1.5 + 1.0 + 0.5)
    assert gaps == [(1.5, 3.0), (4.0, 9.5)]
    spans = [("serve.decode_step", int(1.0e9), int(2.0e9)), ("serve.sample", int(2.0e9), int(5.0e9))]
    by = idle_by_span(gaps, spans)
    assert by["serve.decode_step"] == pytest.approx(0.5)
    assert by["serve.sample"] == pytest.approx(1.0 + 1.0)
    assert by["other"] == pytest.approx(4.5)
    rec = dict(busy_s=busy, window_s=10.0, kernels=ks[:3], k1_bound_ms=250.0)
    assert READ["device.idle_pct"](rec) == pytest.approx(70.0)
    assert READ["k1_roofline"](rec) == pytest.approx(25.0)
    assert READ["k1_roofline"](dict(rec, kernels=[ks[0]])) is None
