"""The port's serving entry point on the CPU: ``python -m
repro_torch.launch.serve --device cpu`` runs the reduced yi-34b through
prefill and decode rounds with one analysis window per round, and the
default device (the card) raises where there is none instead of falling
back to the host."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch.serve import build_config, serve  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _run(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          env=env, capture_output=True, text=True, timeout=600)


def test_cli_cpu_prints_three_window_timeline():
    out = _run("--device", "cpu", "--tokens", "2", "--rounds", "3",
               "--policies", "all")
    assert out.returncode == 0, out.stderr
    assert "=== analysis session: 3 window(s) ===" in out.stdout
    for rnd in range(3):
        assert f"[round {rnd}] internal bottlenecks:" in out.stdout
    assert "timeline:" in out.stdout
    assert "tok/s (host CPU)" in out.stdout


def test_cli_without_card_raises_instead_of_falling_back():
    out = _run("--tokens", "1", "--rounds", "1",
               env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "analysis session" not in out.stdout


@pytest.mark.parametrize("sync_analysis", [False, True])
def test_serve_function_result(sync_analysis):
    cfg = reduced_config("yi-34b", n_heads=8, n_kv_heads=2)
    res = serve(cfg, batch=2, prompt_len=8, tokens=3, rounds=2, schema="tpu",
                policies="all", sync_analysis=sync_analysis, device="cpu")
    assert res.tokens.shape == (2, 1 + 2 * 3)
    assert res.tokens.dtype == np.int64 and (res.tokens < cfg.vocab_size).all()
    assert len(res.report.windows) == 2
    assert res.prefill_logits.shape == (2, 1, cfg.vocab_size)
    assert res.decode_tokens == 12 and res.decode_tok_s > 0
    # greedy decoding is deterministic for a seed
    again = serve(cfg, batch=2, prompt_len=8, tokens=3, rounds=2,
                  sync_analysis=True, device="cpu")
    np.testing.assert_array_equal(again.tokens, res.tokens)


def test_build_config_widths():
    assert build_config("yi-34b", False, None) == reduced_config("yi-34b")
    full = build_config("yi-34b", True, 12)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.n_layers) == (7168, 56, 8, 12)
    with pytest.raises(KeyError, match="not ported"):
        build_config("rwkv6-3b", False, None)
