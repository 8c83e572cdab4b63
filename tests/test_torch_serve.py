"""The port's serving entry point on the CPU: ``python -m
repro_torch.launch.serve --device cpu`` runs the reduced mixtral-8x7b (the
default), gemma2-27b, moonshot-v1-16b-a3b, rwkv6-3b, recurrentgemma-9b and
whisper-large-v3 (with frames drawn from the run's seed) through prefill
and decode rounds with one analysis window per round, and the default
device (the card) raises where there is none instead of falling back to
the host.  The serving path's kernel calls are rehearsed for all ten
architectures, whisper's cross-attention (Sq != Sk) included."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import list_archs, reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as k1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as k2  # noqa: E402
from repro_torch.kernels import wkv6 as k3  # noqa: E402
from repro_torch.launch.serve import build_config, serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import Kernels  # noqa: E402
from _torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def _run(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **ONE_THREAD_ENV,
               **(env_extra or {}))
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
    assert "[serve] mixtral-8x7b (d_model=64" in out.stdout


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b", "gemma2-27b",
                                  "moonshot-v1-16b-a3b", "whisper-large-v3"])
def test_cli_cpu_recurrent_archs(arch):
    """The two recurrent families at reduced size on the host: one analysis
    window per round."""
    out = _run("--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "20",
               "--tokens", "2", "--rounds", "2")
    assert out.returncode == 0, out.stderr
    assert "=== analysis session: 2 window(s) ===" in out.stdout
    assert f"[serve] {arch} (d_model=64" in out.stdout


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b", "whisper-large-v3"])
def test_cli_recurrent_archs_without_card_raise(arch):
    out = _run("--arch", arch, "--tokens", "1", "--rounds", "1",
               env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


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
    for arch, widths in (("rwkv6-3b", (2560, 40, 40, 32)),
                         ("recurrentgemma-9b", (4096, 16, 1, 38))):
        assert build_config(arch, False, None) == reduced_config(arch)
        full = build_config(arch, True, None)
        assert (full.d_model, full.n_heads, full.n_kv_heads, full.n_layers) == widths
    for arch, widths in (("mixtral-8x7b", (4096, 32, 8, 16)),
                         ("gemma2-27b", (4608, 32, 16, 46))):
        full = build_config(arch, True, 16 if arch == "mixtral-8x7b" else None)
        assert (full.d_model, full.n_heads, full.n_kv_heads, full.n_layers) == widths
    assert build_config("whisper-large-v3", False, None) == reduced_config("whisper-large-v3")
    full = build_config("whisper-large-v3", True, None)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.d_head, full.n_layers,
            full.encoder_layers, full.encoder_seq) == (1280, 20, 20, 64, 32, 32, 1500)
    with pytest.raises(KeyError, match="unknown architecture"):
        build_config("llama-99b", False, None)


def test_whisper_serve_draws_frames_from_the_seed():
    """An encoder-decoder's frames come from the prompts' generator: the
    same run twice gives the same frames and tokens; the frames are in the
    compute dtype at the encoder's length."""
    cfg = reduced_config("whisper-large-v3")
    runs = [serve(cfg, batch=2, prompt_len=8, tokens=2, rounds=1, sync_analysis=True,
                  device="cpu") for _ in range(2)]
    assert runs[0].frames.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert runs[0].frames.dtype == torch.bfloat16
    assert torch.equal(runs[0].frames, runs[1].frames)
    np.testing.assert_array_equal(runs[0].tokens, runs[1].tokens)
    assert serve(reduced_config("yi-34b"), batch=2, prompt_len=8, tokens=1, rounds=1,
                 sync_analysis=True, device="cpu").frames is None


@pytest.mark.parametrize("arch", list_archs())
def test_serving_path_feeds_kernels_what_they_take(arch):
    """The serving path's calls of K1, K2 and K3, rehearsed on the host: each
    call's arguments (as ``kernels.ops`` hands them to the kernel) pass the
    kernel wrapper's own checks of dtype, shape and contiguity, and each
    kernel is called once per layer of its kind per prefill and per decode
    step, as ``chip_smoke.py`` counts launches on the card.  An
    encoder-decoder's prefill also calls K1 once per encoder layer (Sq = Sk
    = encoder_seq, non-causal) and once per decoder layer's
    cross-attention (Sq = the prompt's 20 against Sk = encoder_seq)."""
    calls = {"attention": 0, "wkv6": 0, "rglru_scan": 0}
    shapes = []

    def attention(q, k, v, **kw):
        k1.check_inputs(q, k, v)
        calls["attention"] += 1
        shapes.append((q.shape[1], k.shape[1], kw["causal"]))
        return ops.attention(q, k, v, **kw)

    def wkv6(*args):
        k3.check_inputs(*ops.wkv6_kernel_args(*args))
        calls["wkv6"] += 1
        return ops.wkv6(*args)

    def rglru_scan(a, b, h0=None):
        k2.check_inputs(a, b, None if h0 is None else h0.float())
        calls["rglru_scan"] += 1
        return ops.rglru_scan(a, b, h0)

    kernels = Kernels(attention, wkv6, rglru_scan)
    cfg = reduced_config(arch, param_dtype="bfloat16")
    model = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).bfloat16()
    steps = 2
    logits, cache = model.prefill(tokens, 20 + steps, kernels=kernels, frames=frames)
    for step in range(steps):
        logits, cache = model.decode_step(logits[:, -1:].argmax(-1), 20 + step, cache,
                                          kernels=kernels)
    assert torch.isfinite(logits).all()
    kinds = cfg.layer_kinds
    n_attn = sum(k not in ("rec", "rwkv") for k in kinds)
    enc, cross = cfg.encoder_layers, n_attn if cfg.is_encdec else 0
    assert calls == {"attention": n_attn + enc + cross,   # decode attention is plain
                     "wkv6": kinds.count("rwkv") * (1 + steps),
                     "rglru_scan": kinds.count("rec") * (1 + steps)}
    Se = cfg.encoder_seq
    assert shapes == ([(Se, Se, False)] * enc
                      + [(20, 20, True), (20, Se, False)] * cross
                      + ([] if cross else [(20, 20, True)] * n_attn))
