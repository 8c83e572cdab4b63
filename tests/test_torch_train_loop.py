"""The port's training driver on the CPU (``--device cpu``), mirroring the
driver cases of ``tests/test_train_integration.py`` at reduced widths and a
few steps each: the main smoke with checkpoints, resume at the saved step
with the data partition restored from the manifest, an injected data
bottleneck appearing in the window that contains it, the simulated pod's
rebalance firing, the partitioned pipeline's reshard actuation, ``--costs
hlo`` and ``--schema tpu`` printing the counted step's ``[costs]`` line
(no flag refused for want of a port), the six families of slice 7
training a few steps, and mixtral's bf16 parameters with the fp32 master
checkpointed and resumed bit for bit.  The analysis side's
flags run as the reference's: ``--pod-gather`` delivers every window,
``--chaos-seed`` leaves the reference's audit lines on the same command
line, and ``--diagnosis learned`` diagnoses each window as the reference's
strategy diagnoses the same window blobs.  Without
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
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import main, run  # noqa: E402
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b", "gemma2-27b",
                                  "nemotron-4-15b", "qwen1.5-110b", "pixtral-12b"])
def test_new_families_train(arch):
    res = run(["--arch", arch, "--steps", "2", *SMALL, "--analyze-every", "2"])
    assert len(res.losses) == 2 and all(math.isfinite(x) for x in res.losses)
    assert len(res.report.windows) == 1


def test_bf16_moe_checkpoint_is_refused_before_training(tmp_path):
    """No longer refused: mixtral checkpoints and resumes.  Its bf16
    parameters, fp32 master and fp32 moments are saved at step 2 (bf16 as
    ``V2``), ``--resume`` takes the run to step 4, and the losses and the
    final state are those of an uninterrupted 4-step run bit for bit.  At
    seq 640 the attention takes the windowed KV band (two q-chunks)."""
    base = ["--arch", "mixtral-8x7b", *SMALL, "--batch", "1", "--seq", "640",
            "--analyze-every", "2"]
    first = run([*base, "--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    resumed = run([*base, "--steps", "4", "--ckpt-dir", str(tmp_path), "--resume"])
    whole = run([*base, "--steps", "4"])
    assert resumed.start_step == 2 and ckpt.latest_step(tmp_path) == 4
    assert first.losses + resumed.losses == whole.losses
    assert first.grad_norms + resumed.grad_norms == whole.grad_norms
    got = dict(resumed.state["params"].named_parameters())
    want = dict(whole.state["params"].named_parameters())
    assert {p.dtype for p in got.values()} == {torch.bfloat16}
    pairs = [(got, want)] + [(resumed.state["opt"][k], whole.state["opt"][k])
                             for k in ("m", "v", "master")]
    for a, b in pairs:
        assert set(a) == set(b)
        for name in a:
            assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name
    assert torch.equal(resumed.state["opt"]["step"], whole.state["opt"]["step"])


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
    (["--costs", "hlo"], "costs_hlo"),
    (["--schema", "tpu"], "costs_hlo"),
])
def test_unported_flags_raise(flags, reason, capsys):
    """Formerly refused (ROADMAP section 1.7): both flag sets now run on the
    step's counted costs, ``--costs hlo`` under either schema."""
    assert main([*SMALL, "--steps", "2", "--analyze-every", "2", *flags]) == 0
    out = capsys.readouterr().out
    m = re.search(r"\[costs\] hlo step: hlo_flops=([\d.e+]+) hbm_bytes=([\d.e+]+) "
                  r"collective_bytes=0\.000e\+00", out)
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0, reason
    assert "[costs] coverage: step:" in out


def test_only_hlo_costs_stay_unported():
    """No flag is refused for want of a port any more: the refusal table is
    gone and the help names no ROADMAP section."""
    assert not hasattr(train_mod, "NOT_PORTED")
    ap_help = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--help"],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"), **ONE_THREAD_ENV),
        capture_output=True, text=True, check=True, timeout=300).stdout
    assert "ROADMAP" not in ap_help and "not ported" not in ap_help


def test_pod_gather_delivers_every_window(capsys):
    res = run([*SMALL, "--steps", "6", "--analyze-every", "2", "--pod-gather",
               "--policies", "quarantine"])
    assert len(res.report.windows) == 3
    assert not any(w.failed for w in res.report.windows)
    assert res.health.windows == 3 and res.health.ok[0] == 3
    assert res.health.bad(0) == 0 and res.health.missing[0] == 0
    assert "transport health: 3 windows" in capsys.readouterr().out


CHAOS = ["--steps", "6", "--analyze-every", "2", "--sim-ranks", "4",
         "--chaos-seed", "3", "--chaos-hosts", "2", "--policies", "all"]
# the audit lines, cut where a line printed by another thread may follow:
# the step loop's, in their order, and the analysis thread's FAILED lines,
# in theirs (the two threads' lines interleave as the scheduler has it)
AUDIT = re.compile(r"\[chaos\][^\[\n]*|\[transport\][^\[\n]*|transport health:.*"
                   r"|  host \d+: ok=.*")
FAILED = re.compile(r"\[analysis\] window [^\[\n]*FAILED[^\[\n]*")


def _audit(out):
    return AUDIT.findall(out), FAILED.findall(out)


def test_chaos_audit_lines_match_the_reference(capsys):
    from repro.launch.train import main as reference_main
    res = run([*SMALL, *CHAOS])
    port, port_failed = _audit(capsys.readouterr().out)
    assert reference_main(SMALL[2:] + CHAOS) == 0
    assert (port, port_failed) == _audit(capsys.readouterr().out)
    assert "[chaos] injector armed: seed 3, 2 host shard(s) per window" in port
    assert "[transport] window w2 host 1: corrupt" in port
    assert any("FAILED: ChaosError: injected analyzer fault at window 1" in l
               for l in port_failed)
    # the forced analyzer fault is a supervised tombstone; host 1's ranks
    # are gap-masked in window 2
    windows = res.report.windows
    assert [w.failed for w in windows] == [False, True, False]
    assert set(windows[2].gap_ranks) == {2, 3}
    assert res.health.corrupt[1] >= 1


def test_chaos_hosts_beyond_the_pod_exit_2(capsys):
    with pytest.raises(SystemExit) as exc:
        main([*SMALL, "--steps", "1", "--sim-ranks", "4", "--chaos-seed", "3",
              "--chaos-hosts", "5"])
    assert exc.value.code == 2
    assert "--chaos-hosts must be in [1, 4]" in capsys.readouterr().err


def test_learned_diagnosis_matches_the_reference(tmp_path, capsys):
    from repro.core import journal as jjournal
    from repro.perfdbg.corpus import default_learned_strategy
    path = tmp_path / "windows.journal"
    res = run([*SMALL, "--steps", "6", "--analyze-every", "2", "--sim-ranks", "4",
               "--inject-bottleneck-at", "3", "--diagnosis", "learned",
               "--journal", str(path)])
    assert "[train] diagnosis strategy: learned" in capsys.readouterr().out
    port = [w.diagnosis for w in res.report.windows]
    ref = [w.diagnosis for w in jjournal.replay(
        str(path), strategy=default_learned_strategy()).report().windows]
    assert len(port) == len(ref) == 3
    assert any(d.kind != "none" for d in port)
    assert [(d.kind, d.regions, d.ranks, d.scope, d.strategy) for d in port] == \
        [(d.kind, d.regions, d.ranks, d.scope, d.strategy) for d in ref]
    assert [d.confidence for d in port] == pytest.approx(
        [d.confidence for d in ref], rel=1e-5)


def test_tpu_schema_with_analytic_costs_runs(capsys):
    assert main([*SMALL, "--steps", "2", "--analyze-every", "2",
                 "--schema", "tpu", "--costs", "analytic"]) == 0
    assert "hlo_flops=" in capsys.readouterr().out


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--steps", "1", "--batch", "2", "--seq", "8"])
