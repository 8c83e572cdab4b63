"""The port's training driver on the CPU (``--device cpu``), mirroring the
driver cases of ``tests/test_train_integration.py`` at reduced widths and a
few steps each: the main smoke with checkpoints, resume at the saved step
with the data partition restored from the manifest, an injected data
bottleneck appearing in the window that contains it, the simulated pod's
rebalance firing, the partitioned pipeline's reshard actuation, and the
refusal of every flag whose slice is not ported yet.  Without
``--device cpu`` and without a card the trainer raises; it never falls back
to the host."""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.kernels import flash_attention as k1  # noqa: E402
from repro_torch.kernels import rglru_scan as k2  # noqa: E402
from repro_torch.kernels import wkv6 as k3  # noqa: E402
from repro_torch.launch.train import NOT_PORTED, main, run  # noqa: E402
from _torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--batch", "2", "--seq", "32", "--d-model", "128"]


def test_cli_runs_to_the_session_timeline():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", "--steps", "6", "--analyze-every",
                          "3", "--policies", "all"],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "=== analysis session: 2 window(s) ===" in out.stdout
    assert "timeline:" in out.stdout
    assert "[train] device: host CPU" in out.stdout
    assert re.search(r"\[train\] loss [\d.]+ -> [\d.]+", out.stdout)


def test_train_main_smoke(tmp_path, capsys):
    launches = (k1.flash_attention.launches, k2.rglru_scan_kernel.launches,
                k3.wkv6_kernel.launches)
    rc = main(["--arch", "yi-34b", "--steps", "4", *SMALL,
               "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
               "--analyze-every", "2"])
    assert rc == 0
    assert ckpt.latest_step(tmp_path) == 4
    out = capsys.readouterr().out
    assert "=== analysis session: 2 window(s) ===" in out
    assert "[costs] analytic step: hlo_flops=" in out
    # training runs the plain forms: no kernel wrapper was entered
    assert (k1.flash_attention.launches, k2.rglru_scan_kernel.launches,
            k3.wkv6_kernel.launches) == launches


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_recurrent_archs_train(arch):
    res = run(["--arch", arch, "--steps", "2", *SMALL, "--analyze-every", "2"])
    assert len(res.losses) == 2 and all(math.isfinite(x) for x in res.losses)
    assert len(res.report.windows) == 1


def test_resume_continues_at_the_saved_step(tmp_path, capsys):
    base = [*SMALL, "--batch", "4", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--analyze-every", "3",
            "--data-hosts", "2", "--data-skew", "3"]
    first = run([*base, "--steps", "3"])
    capsys.readouterr()
    res = run([*base, "--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert f"[train] restored step 3 from {tmp_path}" in out
    assert "[train] data partition restored: [0.75, 0.25]" in out
    assert res.start_step == 3 and len(res.losses) == 2
    assert ckpt.latest_step(tmp_path) == 5
    # the resumed run's first step is the uninterrupted run's fourth
    full = run([*SMALL, "--batch", "4", "--steps", "4", "--analyze-every", "3",
                "--data-hosts", "2", "--data-skew", "3"])
    assert first.losses == full.losses[:3]
    assert res.losses[0] == pytest.approx(full.losses[3], rel=1e-6)


def test_injected_bottleneck_appears_in_its_window(capsys):
    rc = main(["--steps", "6", *SMALL, "--analyze-every", "2",
               "--inject-bottleneck-at", "3", "--inject-ms", "150"])
    out = capsys.readouterr().out
    assert rc == 0
    line = next(l for l in out.splitlines() if l.startswith("[window 1] steps 3-4"))
    assert "appeared: ['data']" in line, out


def test_sim_ranks_fire_rebalance(capsys):
    rc = main(["--steps", "12", *SMALL, "--analyze-every", "2",
               "--sim-ranks", "6", "--inject-bottleneck-at", "3",
               "--policies", "all"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "simulated pod: 6 ranks" in out
    assert re.search(r"rebalance/rebalance target=5: fired", out)
    assert "[policy] applied rebalance from window" in out


def test_data_hosts_reshard_actuates(capsys):
    rc = main(["--steps", "16", *SMALL, "--batch", "8", "--analyze-every", "2",
               "--data-hosts", "2", "--data-skew", "3", "--policies", "reshard"])
    out = capsys.readouterr().out
    assert rc == 0
    assert re.search(r"\[actuate\] reshard/reshard @w\d+ evidence=\[[\d, ]+\]: "
                     r"pipeline partition \[0\.75, 0\.25\] -> \[0\.5, 0\.5\] "
                     r"\(rows \[4, 4\]/batch\)", out)


@pytest.mark.parametrize("flags,reason", [
    (["--pod-gather"], "pod_gather"),
    (["--chaos-seed", "3"], "chaos_seed"),
    (["--chaos-hosts", "2"], "chaos_seed"),
    (["--costs", "hlo"], "costs_hlo"),
    (["--schema", "tpu"], "costs_hlo"),
    (["--diagnosis", "learned"], "learned"),
])
def test_unported_flags_raise(flags, reason, capsys):
    with pytest.raises(SystemExit) as exc:
        main([*SMALL, "--steps", "1", *flags])
    assert exc.value.code == 2
    assert NOT_PORTED[reason] in capsys.readouterr().err


def test_tpu_schema_with_analytic_costs_runs(capsys):
    assert main([*SMALL, "--steps", "2", "--analyze-every", "2",
                 "--schema", "tpu", "--costs", "analytic"]) == 0
    assert "hlo_flops=" in capsys.readouterr().out


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--steps", "1", "--batch", "2", "--seq", "8"])
