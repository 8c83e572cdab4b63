"""On the card only: each cell runs a few seconds through ``run.py`` and its
last line holds every key the contract asks for; the float8 control of each
cell, at the cell's own size, reads above the cell's limit.

    PYTHONPATH=src python -m pytest -q -m cuda cardbench/tests
"""
import json
import subprocess
import sys

import pytest
import torch

from _tiny import BENCH
from harness import manifest

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_a_few_seconds(card, name, trace):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", name,
                        "--seed", str(2**32 + 17), "--seconds", "3", "--trace", str(trace)],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = manifest.cell(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["metrics"]["k1_roofline"]["value"] <= 100


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    import time

    from harness import cell_run, judge
    cell = manifest.cell(name)
    out = cell_run.run(cell, 2**32 + 29, 3.0, False, time.perf_counter(), card, control=True)
    assert any(out["check"]["control_" + name] > limit
               for name, limit in cell.limits.items())
    assert judge.verdict(out["check"], cell.limits)
