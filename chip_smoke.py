#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card of compute capability >= 9.0 and ``nvcc``; exits
non-zero, printing no result, when there is no card or no port beside the
script.  Phases, each raising on failure (nothing is caught):

  build  compile every kernel of the serving path from ``src/repro_torch/csrc``
         (one nvcc per source, started together);
  A      each kernel against its plain PyTorch version on the card, case by
         case (the tolerances of the JAX package's kernel tests: bf16 2e-2,
         f32 1e-5, TF32 off), including the serving prefill shape;
  B      the serving path: ``repro_torch.launch.serve.serve`` on yi-34b at
         its published widths, depth cut to 12 layers (the only cut), bf16
         weights drawn from a seed, batch 4, prompt 2048, 3 rounds x 16
         tokens, all policies, async windowed analysis.  The flash-attention
         kernel must launch once per layer of the prefill; the session must
         report 3 windows; the prefill's last-position logits must agree with
         a prefill through the plain attention (``models.layers.mha``) on the
         same weights;
  C      CUDA-event timings at the prefill shape: the kernel, its plain
         version, its bound and, as a yardstick the port never calls,
         ``F.scaled_dot_product_attention``.

The last lines are the card's name and power limit, one JSON line of kernel
records, and the verdict ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

N_LAYERS = 12
BATCH, PROMPT, ROUNDS, TOKENS = 4, 2048, 3, 16
H, KH, DH = 56, 8, 128           # yi-34b attention widths
TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=1e-5, atol=1e-5)}
LOGITS_TOL = dict(rtol=5e-2, atol=1e-1)   # bf16 model, as the JAX package's
                                          # prefill/decode consistency test

# Dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():     # most specific first
        if key in name:
            return key, val
    raise RuntimeError(f"no peak rates known for {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qkv(B, S, h, kh, dh, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn((B, S, n, dh), generator=g, device="cuda").to(dtype)
    return mk(h), mk(kh), mk(kh)


def phase_a(torch, ops, fa):
    """Kernel vs plain version; returns the max abs error at the prefill shape."""
    cases = [  # name, B, S, H, KH, dh, dtype, kwargs
        ("causal yi", 2, 1024, H, KH, DH, "bfloat16", dict(causal=True)),
        ("causal yi", 2, 1024, H, KH, DH, "float32", dict(causal=True)),
        ("window=256", 2, 1024, H, KH, DH, "float32", dict(causal=True, window=256)),
        ("softcap=50", 2, 1024, H, KH, DH, "float32", dict(causal=True, softcap=50.0)),
        ("softcap=50", 2, 1024, H, KH, DH, "bfloat16", dict(causal=True, softcap=50.0)),
        ("ragged S=1000", 2, 1000, H, KH, DH, "float32", dict(causal=True)),
        ("ragged S=1000", 2, 1000, H, KH, DH, "bfloat16", dict(causal=True, window=100)),
        ("non-causal", 2, 512, H, KH, DH, "float32", dict(causal=False)),
        ("dh=16", 2, 300, 8, 2, 16, "float32", dict(causal=True)),
        ("dh=32", 2, 256, 8, 4, 32, "bfloat16", dict(causal=True)),
        ("dh=64 scale", 2, 256, 8, 8, 64, "float32", dict(causal=True, scale=0.2)),
        ("GQA G=1", 2, 512, 8, 8, DH, "bfloat16", dict(causal=True)),
        ("GQA G=7", 2, 512, 14, 2, DH, "float32", dict(causal=True)),
        ("prefill shape", BATCH, PROMPT, H, KH, DH, "bfloat16", dict(causal=True)),
    ]
    err = None
    for i, (name, B, S, h, kh, dh, dt, kw) in enumerate(cases):
        q, k, v = qkv(B, S, h, kh, dh, getattr(torch, dt), seed=100 + i)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ops.attention_ref(q, k, v, **kw)
        e = (got.float() - want.float()).abs().max().item()
        print(f"[A] {name:14s} B={B} S={S} H={h} K={kh} dh={dh} {dt:8s} "
              f"{kw}: max|err|={e:.3e} tol={TOL[dt]}")
        torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
        if name == "prefill shape":
            err = e
        del q, k, v, got, want
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port at {SRC / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import mha

    dev = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(dev)}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build(["flash_attention"])
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for line in (_build.BUILD_DIR / "flash_attention.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # -- A: kernel vs plain --------------------------------------------------
    max_err = phase_a(torch, ops, fa)
    torch.cuda.empty_cache()

    # -- B: the serving path ---------------------------------------------------
    cfg = dataclasses.replace(get_config("yi-34b"), n_layers=N_LAYERS,
                              param_dtype="bfloat16")
    print(f"[B] serving {cfg.name} at full width (d_model={cfg.d_model}, "
          f"H={cfg.n_heads}, K={cfg.n_kv_heads}, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}); depth cut 60 -> {N_LAYERS} layers")
    fa.flash_attention.launches = 0
    res = serve(cfg, batch=BATCH, prompt_len=PROMPT, tokens=TOKENS,
                rounds=ROUNDS, policies="all", device="cuda")
    launches = fa.flash_attention.launches
    if launches != N_LAYERS:
        raise RuntimeError(f"flash attention launched {launches} times on the "
                           f"serving path, expected {N_LAYERS} (one per layer)")
    windows = res.report.windows
    if len(windows) != ROUNDS:
        raise RuntimeError(f"{len(windows)} analysis windows, expected {ROUNDS}")
    for w in windows:
        if w.failed:
            raise RuntimeError(f"analysis window {w.title()} failed")
        cccrs = [res.tree.name(r) for r in w.report.internal.cccrs]
        print(f"[B] window {w.title()}: internal bottlenecks {cccrs or ['(none)']}")
    if res.tokens.shape != (BATCH, 1 + ROUNDS * TOKENS):
        raise RuntimeError(f"decoded tokens have shape {res.tokens.shape}")
    if not torch.isfinite(res.prefill_logits).all():
        raise RuntimeError("non-finite prefill logits")
    s_buf = PROMPT + ROUNDS * TOKENS
    plain_logits, _ = res.model.prefill(res.prompts, s_buf, attention=mha)
    lerr = (plain_logits - res.prefill_logits).abs().max().item()
    agree = (plain_logits.argmax(-1) == res.prefill_logits.argmax(-1)).float().mean().item()
    print(f"[B] prefill logits, kernel vs plain attention: max|err|={lerr:.3e} "
          f"tol={LOGITS_TOL}; greedy-token agreement {agree:.3f}")
    torch.testing.assert_close(res.prefill_logits, plain_logits, **LOGITS_TOL)
    # warm prefill of the same model and prompts, kernel vs plain attention
    warm_ms = cuda_ms(lambda: res.model.prefill(res.prompts, s_buf), iters=3, warmup=1)
    warm_plain_ms = cuda_ms(lambda: res.model.prefill(res.prompts, s_buf, attention=mha),
                            iters=3, warmup=1)
    prefill_ms, tok_s = res.prefill_s * 1e3, res.decode_tok_s
    del res, plain_logits
    torch.cuda.empty_cache()

    # -- C: timings at the prefill shape -----------------------------------------
    q, k, v = qkv(BATCH, PROMPT, H, KH, DH, torch.bfloat16, seed=7)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=10)
    plain_ms = cuda_ms(lambda: ops.attention_ref(q, k, v, causal=True), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                         iters=10)
    peak_name, (flops_peak, bw_peak) = peaks(kind)
    pairs = PROMPT * (PROMPT + 1) // 2            # unmasked (q, k) pairs per head
    flops = 4 * BATCH * H * DH * pairs
    nbytes = 2 * (2 * BATCH * PROMPT * H * DH + 2 * BATCH * PROMPT * KH * DH)
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    shape = f"B={BATCH} S={PROMPT} H={H} K={KH} dh={DH} bf16 causal"
    print(f"[C] flash_attention {shape}: {ms:.4f} ms/call ({flops / ms / 1e9:.1f} "
          f"TFLOP/s) | card: {card}")
    print(f"[C] bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP at "
          f"{peak_name} {flops_peak / 1e12:.0f} TFLOP/s, {nbytes / 1e9:.3f} GB at "
          f"{bw_peak / 1e12:.2f} TB/s) | card: {card}")
    print(f"[C] plain attention_ref: {plain_ms:.4f} ms | library sdpa (yardstick, "
          f"not used by the port): {library_ms:.4f} ms | card: {card}")
    print(f"[C] serving yi-34b x{N_LAYERS} layers: prefill {prefill_ms:.3f} ms "
          f"(batch {BATCH} x {PROMPT}, first call), decode {tok_s:.1f} tok/s "
          f"(batch {BATCH}) | card: {card}")
    print(f"[C] warm prefill yi-34b x{N_LAYERS} layers: {warm_ms:.3f} ms with the "
          f"kernel, {warm_plain_ms:.3f} ms with plain attention (layers.mha) | card: {card}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:35",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
