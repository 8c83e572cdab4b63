"""A run with the timed path broken underneath comes out not correct, for
each fault a serving cell can have; the same run unbroken is correct.  Tiny
copies of each family's cell on the CPU, held to that cell's own limit."""
import pytest

import _tiny
from harness import faults, judge


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_sound_run_is_correct(family):
    c = _tiny.cell(family, batch=4, output_tokens=9, judge_requests=8)
    out = _tiny.run(c)
    assert judge.verdict(out["check"], c.limits), out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 4


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_fault_is_not_correct(family, fault):
    c = _tiny.cell(family, batch=4, output_tokens=9, judge_requests=8)
    with faults.planted(fault):
        out = _tiny.run(c)
    assert not judge.verdict(out["check"], c.limits), out["check"]


@pytest.mark.parametrize("batch, judged", [(8, 16), (64, 16), (4, 2), (3, 8)])
def test_the_sample_reads_every_part_of_a_batch(batch, judged):
    """Each row stratum of the batch is sampled, so the second half of a
    batch is always read, whatever the seed."""
    tr = _tiny.traffic(batch=batch, judge_requests=judged)
    for seed in range(40):
        picks = judge.sample(range(5), tr, seed)
        assert len(picks) == min(judged, 5 * batch) == len(set(picks))
        assert any(r >= batch // 2 for _, r in picks)
        assert any(r < batch // 2 for _, r in picks)
        strata = min(judged, batch)
        assert {r * strata // batch for _, r in picks} == set(range(strata))
