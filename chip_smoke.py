#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card of compute capability >= 9.0 and ``nvcc``; exits
non-zero, printing no result, when there is no card or no port beside the
script.  Phases, each raising on failure (nothing is caught):

  build  compile every kernel source of ``src/repro_torch/csrc`` (one nvcc
         per source, started together) and print ptxas's registers and
         spills for each instantiation;
  A      each kernel against its plain PyTorch version on the card, case by
         case (the tolerances of the JAX package's kernel tests: bf16 2e-2,
         f32 1e-5, TF32 off), including each serving shape: K1 (flash
         attention; each case prints the kernel its dtype and head size
         choose: ``"wgmma"``, the tensor-core kernel, for bf16 at d_head 128
         and 256, ``"simt"`` otherwise; also at d_head 256 with 16 query
         heads on one KV head and a window), K3 (WKV6, y and the final state,
         T = 1 from a state, ragged T, d_head 32: two blocks of value columns
         per head, with B*H = 21) and K2 (RG-LRU scan, equal to the plain
         loop bit for bit; each case prints the kernel its shape chooses:
         ``"staged"``, a and b staged by TMA, for S > 1 with W % 4 == 0,
         ``"simple"`` otherwise; from h0, S = 1, ragged S and W);
  B      the serving path, ``repro_torch.launch.serve.serve`` with all
         policies and async windowed analysis, bf16 weights drawn from a
         seed, 3 rounds x 16 tokens, on three models in turn (each freed
         before the next):
           yi-34b at its published widths, depth cut to 12 layers (the only
             cut), batch 4, prompt 2048: K1 once per layer per prefill;
           rwkv6-3b at published widths and full depth (32 layers), batch 4,
             prompt 2048: K3 once per layer per prefill and decode step;
           recurrentgemma-9b at published widths and full depth (38 layers),
             batch 2, prompt 4096 (longer than its 2048 window, so the window
             mask and the ring-buffer cache do real work): K2 once per rec
             layer per prefill and decode step, K1 once per local layer per
             prefill.
         Every kernel's launch count is set to 0 just before a model is
         served and read just after, every K1 launch must have gone
         through ``"wgmma"``, and K2's launches split by kernel: the
         prefill's on ``"staged"``, the decode steps' on ``"simple"``; the
         session must report one window per
         round; the prefill's last-position logits must agree with a prefill
         through the models' plain forms (``transformer.PLAIN``) on the same
         weights (bf16: rtol 5e-2, atol 1e-1 times the logits' rms where
         that exceeds 1, as for recurrentgemma's tied embedding);
  C      CUDA-event timings at the serving shapes: each kernel, its plain
         version, its bound and, for K1, ``F.scaled_dot_product_attention``
         as a yardstick the port never calls (no single PyTorch call
         computes K2's or K3's recurrence), and K1's SIMT kernel at the same
         bf16 shapes as the time before the tensor-core kernel; K2's staged
         and simple kernels alternated at recurrentgemma-9b's prefill shape
         (the simple one is the time before), with TB/s, the grid and the
         staged kernel's compiled schedule; K2 and K3 also at their decode
         shapes (S = 1 from h0, T = 1 from a state; device time over a CUDA
         graph, since an eager call costs the host more), with K3's grid and
         compiled schedule (CTAs resident per SM) printed.

The last lines are the card's name and power limit, one JSON line of kernel
records, and the verdict ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

ROUNDS, TOKENS = 3, 16
YI_LAYERS, YI_BATCH, YI_PROMPT = 12, 4, 2048
RWKV_BATCH, RWKV_PROMPT = 4, 2048
RG_BATCH, RG_PROMPT = 2, 4096
H, KH, DH = 56, 8, 128           # yi-34b attention widths
RG_H, RG_KH, RG_DH, RG_WINDOW, RG_W = 16, 1, 256, 2048, 4096   # recurrentgemma-9b
RWKV_H, RWKV_DH = 40, 64         # rwkv6-3b heads
GRAPH_CALLS = 50                 # K2 or K3 launches per CUDA graph at the decode shape
TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=1e-5, atol=1e-5)}
LOGITS_TOL = dict(rtol=5e-2, atol=1e-1)   # bf16 model, as the JAX package's
                                          # prefill/decode consistency test

# Dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, fp32 (no tensor
# cores) FLOP/s, HBM bytes/s.
PEAKS = {"H100 PCIe": (756e12, 51.2e12, 2.0e12), "H100 NVL": (835e12, 60e12, 3.9e12),
         "H100": (989e12, 67e12, 3.35e12)}


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


def bound(flops: float, nbytes: float, flops_peak: float, bw_peak: float):
    """(least time in ms, what bounds it) for this work on the card."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def timed(fn):
    """(fn's result, its ms on the card by CUDA events), one call."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def qkv(B, S, h, kh, dh, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn((B, S, n, dh), generator=g, device="cuda").to(dtype)
    return mk(h), mk(kh), mk(kh)


def wkv_inputs(B, T, h, dh, dtype, seed, with_s0):
    """r, k, v, logw, u, s0 as the JAX package's kernel tests draw them."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: 0.5 * torch.randn((B, T, h, dh), generator=g, device="cuda")
    r, k, v = mk().to(dtype), mk().to(dtype), mk().to(dtype)
    logw = -torch.exp(torch.clamp(mk(), -3, 0.5))
    u = 0.3 * torch.randn((h, dh), generator=g, device="cuda")
    s0 = torch.randn((B, h, dh, dh), generator=g, device="cuda") if with_s0 else None
    return r, k, v, logw, u, s0


def scan_inputs(B, S, W, seed, with_h0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.2 + 0.79 * torch.rand((B, S, W), generator=g, device="cuda")
    b = torch.randn((B, S, W), generator=g, device="cuda")
    h0 = torch.randn((B, W), generator=g, device="cuda") if with_h0 else None
    return a, b, h0


def phase_a_attention(torch, ops, fa):
    """K1 vs plain; returns the max abs error at each serving prefill shape."""
    rg_kw = dict(causal=True, window=RG_WINDOW)
    cases = [  # name, B, S, H, KH, dh, dtype, kwargs
        ("causal yi", 2, 1024, H, KH, DH, "bfloat16", dict(causal=True)),
        ("causal yi", 2, 1024, H, KH, DH, "float32", dict(causal=True)),
        ("window=256", 2, 1024, H, KH, DH, "float32", dict(causal=True, window=256)),
        ("softcap=50", 2, 1024, H, KH, DH, "float32", dict(causal=True, softcap=50.0)),
        ("softcap=50", 2, 1024, H, KH, DH, "bfloat16", dict(causal=True, softcap=50.0)),
        ("ragged S=1000", 2, 1000, H, KH, DH, "float32", dict(causal=True)),
        ("ragged S=1000", 2, 1000, H, KH, DH, "bfloat16", dict(causal=True, window=100)),
        ("non-causal", 2, 512, H, KH, DH, "float32", dict(causal=False)),
        ("non-causal", 2, 512, H, KH, DH, "bfloat16", dict(causal=False)),
        ("dh=16", 2, 300, 8, 2, 16, "float32", dict(causal=True)),
        ("dh=32", 2, 256, 8, 4, 32, "bfloat16", dict(causal=True)),
        ("dh=64 scale", 2, 256, 8, 8, 64, "float32", dict(causal=True, scale=0.2)),
        ("GQA G=1", 2, 512, 8, 8, DH, "bfloat16", dict(causal=True)),
        ("GQA G=7", 2, 512, 14, 2, DH, "float32", dict(causal=True)),
        ("GQA G=7", 2, 512, 14, 2, DH, "bfloat16", dict(causal=True)),
        ("dh=256 G=16 w", 2, 1000, RG_H, RG_KH, RG_DH, "float32", dict(causal=True, window=300)),
        ("dh=256 G=16 w", 2, 1000, RG_H, RG_KH, RG_DH, "bfloat16", dict(causal=True, window=300)),
        ("dh=256 full", 1, 333, RG_H, RG_KH, RG_DH, "float32", dict(causal=False)),
        ("dh=256 full", 1, 333, RG_H, RG_KH, RG_DH, "bfloat16", dict(causal=False)),
        ("dh=256 causal", 2, 1000, RG_H, RG_KH, RG_DH, "bfloat16", dict(causal=True)),
        ("dh=256 S=37", 2, 37, RG_H, RG_KH, RG_DH, "bfloat16", rg_kw),
        ("prefill yi", YI_BATCH, YI_PROMPT, H, KH, DH, "bfloat16", dict(causal=True)),
        ("prefill rg", RG_BATCH, RG_PROMPT, RG_H, RG_KH, RG_DH, "bfloat16", rg_kw),
    ]
    errs = {}
    for i, (name, B, S, h, kh, dh, dt, kw) in enumerate(cases):
        q, k, v = qkv(B, S, h, kh, dh, getattr(torch, dt), seed=100 + i)
        kind = fa.variant(q.dtype, dh)
        before = fa.flash_attention.launches_by_variant[kind]
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if fa.flash_attention.launches_by_variant[kind] != before + 1:
            raise RuntimeError(f"K1 {name}: no launch of the {kind!r} kernel counted")
        want = ops.attention_ref(q, k, v, **kw)
        e = (got.float() - want.float()).abs().max().item()
        print(f"[A] K1 {name:14s} B={B} S={S} H={h} K={kh} dh={dh} {dt:8s} {kind:5s} "
              f"{kw}: max|err|={e:.3e} tol={TOL[dt]}")
        torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
        errs[name] = e
        del q, k, v, got, want
        free()
    return errs["prefill yi"], errs["prefill rg"]


def phase_a_wkv6(torch, ops, k3):
    """K3 vs plain (y and the final state); returns the max abs error of y
    at the serving prefill shape."""
    cases = [  # name, B, T, H, dh, dtype, with_s0
        ("T=1 from s0", RWKV_BATCH, 1, RWKV_H, RWKV_DH, "float32", True),
        ("T=1 from s0", RWKV_BATCH, 1, RWKV_H, RWKV_DH, "bfloat16", True),
        ("ragged T=37", 2, 37, 8, RWKV_DH, "float32", True),
        ("ragged T=37", 2, 37, 8, RWKV_DH, "bfloat16", False),
        ("T=100 dh=32", 2, 100, 4, 32, "float32", False),
        ("dh=32 BH=21", 3, 17, 7, 32, "bfloat16", True),
        ("T=256", 3, 256, 5, RWKV_DH, "float32", True),
        ("prefill rwkv", RWKV_BATCH, RWKV_PROMPT, RWKV_H, RWKV_DH, "bfloat16", False),
    ]
    err = None
    for i, (name, B, T, h, dh, dt, with_s0) in enumerate(cases):
        args = wkv_inputs(B, T, h, dh, getattr(torch, dt), seed=200 + i, with_s0=with_s0)
        y, s = k3.wkv6_kernel(*args)
        torch.cuda.synchronize()
        y_want, s_want = ops.wkv6_ref(*args)
        ey = (y.float() - y_want.float()).abs().max().item()
        es = (s - s_want).abs().max().item()
        print(f"[A] K3 {name:14s} B={B} T={T} H={h} dh={dh} {dt:8s} s0={with_s0}: "
              f"y max|err|={ey:.3e} tol={TOL[dt]}; s_final max|err|={es:.3e} "
              f"tol={TOL['float32']}")
        torch.testing.assert_close(y.float(), y_want.float(), **TOL[dt])
        torch.testing.assert_close(s, s_want, **TOL["float32"])
        if name == "prefill rwkv":
            err = ey
        del args, y, s, y_want, s_want
        free()
    return err


def phase_a_rglru(torch, ops, k2):
    """K2 vs plain, bit for bit; returns the max abs error at the serving
    prefill shape (0 when it passes)."""
    cases = [  # name, B, S, W, with_h0
        ("S=1 from h0", RG_BATCH, 1, RG_W, True),
        ("from h0", 2, 64, 128, True),
        ("ragged S=37", 3, 37, 100, True),
        ("S=300", 1, 300, 64, False),
        ("S=4097 W=4100", 1, 4097, 4100, True),
        ("odd W=99", 2, 300, 99, True),
        ("prefill rg", RG_BATCH, RG_PROMPT, RG_W, False),
    ]
    err = None
    for i, (name, B, S, W, with_h0) in enumerate(cases):
        args = scan_inputs(B, S, W, seed=300 + i, with_h0=with_h0)
        kind = k2.variant(B, S, W)
        before = k2.rglru_scan_kernel.launches_by_variant[kind]
        got = k2.rglru_scan_kernel(*args)
        torch.cuda.synchronize()
        if k2.rglru_scan_kernel.launches_by_variant[kind] != before + 1:
            raise RuntimeError(f"K2 {name}: no launch of the {kind!r} kernel counted")
        want = ops.rglru_scan_ref(*args)
        e = (got - want).abs().max().item()
        print(f"[A] K2 {name:14s} B={B} S={S} W={W} float32 h0={with_h0} {kind:6s}: "
              f"max|err|={e:.3e}, bit for bit: {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise RuntimeError(f"K2 {name}: the {kind!r} kernel differs from the plain loop")
        if name == "prefill rg":
            err = e
            simple = k2.launch("simple", *args)
            torch.cuda.synchronize()
            print(f"[A] K2 {name:14s} simple kernel (uncounted): bit for bit: "
                  f"{torch.equal(simple, want)}")
            if not torch.equal(simple, want):
                raise RuntimeError("K2: the simple kernel differs from the plain loop")
            del simple
        del args, got, want
        free()
    return err


def serve_model(torch, cfg, batch, prompt, counters, expected):
    """Phase B for one model: serve it with every launch count set to 0
    just before, check the counts (K2's by kernel: the prefill's staged,
    the decode steps' simple), windows, tokens and the kernel-vs-plain
    prefill logits; returns the counts and the timings."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import PLAIN

    print(f"[B] serving {cfg.name} at full width (d_model={cfg.d_model}, "
          f"H={cfg.n_heads}, K={cfg.n_kv_heads}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, "
          f"{cfg.n_layers} layers: {dict((k, cfg.layer_kinds.count(k)) for k in sorted(set(cfg.layer_kinds)))}); "
          f"batch {batch}, prompt {prompt}, {ROUNDS} rounds x {TOKENS} tokens")
    torch.cuda.reset_peak_memory_stats()
    k1, k2 = counters["flash_attention"], counters["rglru_scan"]
    for fn in counters.values():
        fn.launches = 0
    for fn in (k1, k2):
        fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
    res = serve(cfg, batch=batch, prompt_len=prompt, tokens=TOKENS,
                rounds=ROUNDS, policies="all", device="cuda")
    launches = {name: fn.launches for name, fn in counters.items()}
    by_variant = dict(k1.launches_by_variant)
    k2_by_variant = dict(k2.launches_by_variant)
    rec_layers = cfg.layer_kinds.count("rec")
    k2_expected = dict(staged=rec_layers, simple=rec_layers * ROUNDS * TOKENS)
    print(f"[B] {cfg.name}: launches {launches}, expected {expected}; K1 by kernel "
          f"{by_variant}; K2 by kernel {k2_by_variant}, expected {k2_expected}")
    if launches != expected:
        raise RuntimeError(f"{cfg.name}: kernel launches {launches} on the serving "
                           f"path, expected {expected}")
    if by_variant["wgmma"] != launches["flash_attention"]:
        raise RuntimeError(f"{cfg.name}: K1 launches by kernel {by_variant}; every one "
                           f"must go through 'wgmma'")
    if k2_by_variant != k2_expected:
        raise RuntimeError(f"{cfg.name}: K2 launches by kernel {k2_by_variant}; every "
                           f"prefill launch must go through 'staged', every decode "
                           f"step's through 'simple'")
    windows = res.report.windows
    if len(windows) != ROUNDS:
        raise RuntimeError(f"{len(windows)} analysis windows, expected {ROUNDS}")
    for w in windows:
        if w.failed:
            raise RuntimeError(f"analysis window {w.title()} failed")
        cccrs = [res.tree.name(r) for r in w.report.internal.cccrs]
        print(f"[B] {cfg.name} window {w.title()}: internal bottlenecks {cccrs or ['(none)']}")
    if res.tokens.shape != (batch, 1 + ROUNDS * TOKENS):
        raise RuntimeError(f"decoded tokens have shape {res.tokens.shape}")
    if not torch.isfinite(res.prefill_logits).all():
        raise RuntimeError("non-finite prefill logits")
    s_buf = prompt + ROUNDS * TOKENS
    (plain_logits, _), plain_ms = timed(lambda: res.model.prefill(res.prompts, s_buf,
                                                                  kernels=PLAIN))
    lerr = (plain_logits - res.prefill_logits).abs().max().item()
    agree = (plain_logits.argmax(-1) == res.prefill_logits.argmax(-1)).float().mean().item()
    # tied embeddings give logits of rms ~sqrt(d_model) where untied ones
    # have rms ~1: the absolute tolerance is taken relative to the rms
    rms = plain_logits.pow(2).mean().sqrt().item()
    tol = dict(LOGITS_TOL, atol=LOGITS_TOL["atol"] * max(1.0, rms))
    print(f"[B] {cfg.name} prefill logits, kernels vs plain forms: max|err|={lerr:.3e} "
          f"(logits rms {rms:.3f}) tol={tol}; greedy-token agreement {agree:.3f}")
    torch.testing.assert_close(res.prefill_logits, plain_logits, **tol)
    del plain_logits
    warm_ms = cuda_ms(lambda: res.model.prefill(res.prompts, s_buf), iters=2, warmup=1)
    out = dict(launches=launches, k2_by_variant=k2_by_variant,
               prefill_ms=res.prefill_s * 1e3, tok_s=res.decode_tok_s,
               warm_ms=warm_ms, plain_ms=plain_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del res
    free()
    return out


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
    from repro_torch.kernels import rglru_scan as k2
    from repro_torch.kernels import wkv6 as k3

    dev = resolve_device("cuda")
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(dev)}")
    t_start = time.perf_counter()

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build(_build.SOURCES)
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- A: kernels vs plain -----------------------------------------------------
    k1_err, k1_rg_err = phase_a_attention(torch, ops, fa)
    k3_err = phase_a_wkv6(torch, ops, k3)
    k2_err = phase_a_rglru(torch, ops, k2)
    print(f"[A] passed in {time.perf_counter() - t_start:.1f} s since start")

    # -- B: the serving paths ------------------------------------------------------
    counters = {"flash_attention": fa.flash_attention, "rglru_scan": k2.rglru_scan_kernel,
                "wkv6": k3.wkv6_kernel}
    steps = 1 + ROUNDS * TOKENS          # the prefill and every decode step
    bf16 = dict(param_dtype="bfloat16")
    yi = dataclasses.replace(get_config("yi-34b"), n_layers=YI_LAYERS, **bf16)
    rwkv = dataclasses.replace(get_config("rwkv6-3b"), **bf16)
    rg = dataclasses.replace(get_config("recurrentgemma-9b"), **bf16)
    runs = {
        yi.name: serve_model(torch, yi, YI_BATCH, YI_PROMPT, counters, {
            "flash_attention": YI_LAYERS, "rglru_scan": 0, "wkv6": 0}),
        rwkv.name: serve_model(torch, rwkv, RWKV_BATCH, RWKV_PROMPT, counters, {
            "flash_attention": 0, "rglru_scan": 0,
            "wkv6": rwkv.layer_kinds.count("rwkv") * steps}),
        rg.name: serve_model(torch, rg, RG_BATCH, RG_PROMPT, counters, {
            "flash_attention": rg.layer_kinds.count("local"),
            "rglru_scan": rg.layer_kinds.count("rec") * steps, "wkv6": 0}),
    }
    print(f"[B] passed in {time.perf_counter() - t_start:.1f} s since start")

    # -- C: timings at the serving shapes ----------------------------------------------
    peak_name, (bf16_peak, fp32_peak, bw_peak) = peaks(device_kind)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {}

    # K1 at yi-34b's prefill shape
    q, k, v = qkv(YI_BATCH, YI_PROMPT, H, KH, DH, torch.bfloat16, seed=7)
    k1_kind = fa.variant(q.dtype, DH)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=10)
    simt_ms = cuda_ms(lambda: fa.launch("simt", q, k, v, causal=True), iters=3, warmup=1)
    plain_ms = cuda_ms(lambda: ops.attention_ref(q, k, v, causal=True), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    pairs = YI_PROMPT * (YI_PROMPT + 1) // 2            # unmasked (q, k) pairs per head
    flops = 4 * YI_BATCH * H * DH * pairs
    nbytes = 2 * (2 * YI_BATCH * YI_PROMPT * H * DH + 2 * YI_BATCH * YI_PROMPT * KH * DH)
    bound_ms, bound_by = bound(flops, nbytes, bf16_peak, bw_peak)
    print(f"[C] K1 flash_attention B={YI_BATCH} S={YI_PROMPT} H={H} K={KH} dh={DH} bf16 causal: "
          f"{k1_kind} {ms:.4f} ms/call ({flops / ms / 1e9:.1f} TFLOP/s), simt {simt_ms:.4f} ms "
          f"({flops / simt_ms / 1e9:.1f} TFLOP/s); bound {bound_ms:.4f} ms "
          f"({bound_by}; {flops / 1e9:.1f} GFLOP at {peak_name} {bf16_peak / 1e12:.0f} TFLOP/s "
          f"bf16, {nbytes / 1e9:.3f} GB at {bw_peak / 1e12:.2f} TB/s); plain {plain_ms:.4f} ms; "
          f"library sdpa (yardstick, not used by the port) {library_ms:.4f} ms | card: {card}")
    rec["flash_attention"] = dict(variant=k1_kind, ms=ms, simt_ms=simt_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    del q, k, v, qt, kt, vt
    free()

    # K1 at recurrentgemma-9b's prefill shape (d_head 256, G 16, window 2048)
    q, k, v = qkv(RG_BATCH, RG_PROMPT, RG_H, RG_KH, RG_DH, torch.bfloat16, seed=8)
    rg_kw = dict(causal=True, window=RG_WINDOW)
    k1_kind = fa.variant(q.dtype, RG_DH)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **rg_kw), iters=10)
    simt_ms = cuda_ms(lambda: fa.launch("simt", q, k, v, **rg_kw), iters=3, warmup=1)
    plain_ms = cuda_ms(lambda: ops.attention_ref(q, k, v, **rg_kw), iters=2, warmup=1)
    pos = torch.arange(RG_PROMPT, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - RG_WINDOW)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(RG_H // RG_KH, dim=1) for t in (k, v))
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=band), iters=10)
    pairs = sum(min(i + 1, RG_WINDOW) for i in range(RG_PROMPT))
    flops = 4 * RG_BATCH * RG_H * RG_DH * pairs
    nbytes = 2 * (2 * RG_BATCH * RG_PROMPT * RG_H * RG_DH + 2 * RG_BATCH * RG_PROMPT * RG_KH * RG_DH)
    b_ms, b_by = bound(flops, nbytes, bf16_peak, bw_peak)
    print(f"[C] K1 flash_attention B={RG_BATCH} S={RG_PROMPT} H={RG_H} K={RG_KH} dh={RG_DH} bf16 "
          f"window {RG_WINDOW}: {k1_kind} {ms:.4f} ms/call ({flops / ms / 1e9:.1f} TFLOP/s), simt "
          f"{simt_ms:.4f} ms ({flops / simt_ms / 1e9:.1f} TFLOP/s); bound "
          f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB); plain "
          f"{plain_ms:.4f} ms; library sdpa with a band mask on K/V expanded to {RG_H} heads "
          f"(yardstick) {library_ms:.4f} ms "
          f"| card: {card}")
    rec["flash_attention"]["at_dh256"] = dict(variant=k1_kind, ms=ms, simt_ms=simt_ms,
                                              plain_ms=plain_ms, bound_ms=b_ms,
                                              bound_by=b_by, library_ms=library_ms,
                                              max_abs_err=k1_rg_err)
    del q, k, v, qt, kt, vt, band
    free()

    # K3 at rwkv6-3b's prefill shape
    args = wkv_inputs(RWKV_BATCH, RWKV_PROMPT, RWKV_H, RWKV_DH, torch.bfloat16, seed=9,
                      with_s0=False)
    ms = cuda_ms(lambda: k3.wkv6_kernel(*args), iters=10)
    plain_ms = cuda_ms(lambda: ops.wkv6_ref(*args), iters=1, warmup=1)
    BTH = RWKV_BATCH * RWKV_PROMPT * RWKV_H
    flops = 5 * BTH * RWKV_DH * RWKV_DH
    nbytes = (sum(t.numel() * t.element_size() for t in args[:5])   # r, k, v, logw, u
              + BTH * RWKV_DH * 2                                      # y (bf16)
              + RWKV_BATCH * RWKV_H * RWKV_DH * RWKV_DH * 4)           # s_final
    b_ms, b_by = bound(flops, nbytes, fp32_peak, bw_peak)
    print(f"[C] K3 wkv6 B={RWKV_BATCH} T={RWKV_PROMPT} H={RWKV_H} dh={RWKV_DH} bf16: "
          f"{ms:.4f} ms/call ({flops / ms / 1e9:.2f} TFLOP/s fp32); bound {b_ms:.4f} ms "
          f"({b_by}; {flops / 1e9:.2f} GFLOP at {fp32_peak / 1e12:.0f} TFLOP/s fp32, "
          f"{nbytes / 1e9:.3f} GB at {bw_peak / 1e12:.2f} TB/s); plain {plain_ms:.4f} ms; "
          f"library: no single PyTorch call | card: {card}")
    sched = k3.schedule(torch.bfloat16, RWKV_DH)
    n_cta = k3.grid(RWKV_BATCH, RWKV_H, RWKV_DH)
    waves = n_cta / (sched["ctas_per_sm"] * sms)
    print(f"[C] K3 grid {n_cta} CTAs x {sched['threads']} threads ({sched['value_columns']} "
          f"value columns of one (b, h) each), {sched['smem_bytes']} B shared memory per CTA, "
          f"{sched['ctas_per_sm']} CTAs resident per SM x {sms} SMs: {waves:.3f} waves, "
          f"{n_cta / sms:.3f} CTAs per SM")
    rec["wkv6"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       grid=n_cta, schedule=sched)
    del args
    free()

    # K3 at rwkv6-3b's decode shape: one step from the cached state.  An
    # eager call costs the host more than the kernel costs the card, so the
    # kernel's time is taken over a CUDA graph of GRAPH_CALLS launches; the
    # eager call's time is printed beside it.
    args = wkv_inputs(RWKV_BATCH, 1, RWKV_H, RWKV_DH, torch.bfloat16, seed=11, with_s0=True)
    eager_ms = cuda_ms(lambda: k3.wkv6_kernel(*args), iters=200, warmup=5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            k3.wkv6_kernel(*args)
    ms = cuda_ms(graph.replay, iters=10) / GRAPH_CALLS
    plain_ms = cuda_ms(lambda: ops.wkv6_ref(*args), iters=20, warmup=2)
    flops = 5 * RWKV_BATCH * RWKV_H * RWKV_DH * RWKV_DH
    nbytes = (sum(t.numel() * t.element_size() for t in args)            # r, k, v, logw, u, s0
              + RWKV_BATCH * RWKV_H * RWKV_DH * 2                          # y (bf16)
              + RWKV_BATCH * RWKV_H * RWKV_DH * RWKV_DH * 4)               # s_final
    b_ms, b_by = bound(flops, nbytes, fp32_peak, bw_peak)
    print(f"[C] K3 wkv6 decode B={RWKV_BATCH} T=1 H={RWKV_H} dh={RWKV_DH} bf16 from s0: "
          f"{ms * 1e3:.2f} us/call in a CUDA graph of {GRAPH_CALLS} ({eager_ms * 1e3:.2f} us "
          f"per eager call); bound {b_ms * 1e3:.2f} us ({b_by}; {nbytes / 1e6:.2f} MB at "
          f"{bw_peak / 1e12:.2f} TB/s); plain {plain_ms * 1e3:.2f} us | card: {card}")
    rec["wkv6"]["at_decode"] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
    del args, graph
    free()

    # K2 at recurrentgemma-9b's prefill shape: the staged kernel (the entry
    # point) and the simple one (the design it replaced, the time before), alternated
    args = scan_inputs(RG_BATCH, RG_PROMPT, RG_W, seed=10, with_h0=False)
    k2_kind = k2.variant(RG_BATCH, RG_PROMPT, RG_W)
    times = {"staged": [], "simple": []}
    for kind in ("staged", "simple", "simple", "staged"):
        fn = ((lambda: k2.rglru_scan_kernel(*args)) if kind == k2_kind
              else (lambda: k2.launch(kind, *args)))
        times[kind].append(cuda_ms(fn, iters=20))
    ms, simple_ms = min(times["staged"]), min(times["simple"])
    plain_ms = cuda_ms(lambda: ops.rglru_scan_ref(*args), iters=1, warmup=1)
    n = RG_BATCH * RG_PROMPT * RG_W
    flops, nbytes = 2 * n, 3 * n * 4
    b_ms, b_by = bound(flops, nbytes, fp32_peak, bw_peak)
    print(f"[C] K2 rglru_scan B={RG_BATCH} S={RG_PROMPT} W={RG_W} f32: {k2_kind} "
          f"{', '.join(f'{t:.4f}' for t in times['staged'])} ms/call "
          f"({nbytes / ms / 1e9:.3f} TB/s), simple {', '.join(f'{t:.4f}' for t in times['simple'])} "
          f"ms ({nbytes / simple_ms / 1e9:.3f} TB/s); bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes / 1e9:.3f} GB at {bw_peak / 1e12:.2f} TB/s); plain {plain_ms:.4f} ms; "
          f"library: no single PyTorch call | card: {card}")
    sched = k2.schedule()
    n_cta = k2.grid(RG_BATCH, RG_W)
    waves = n_cta / (sched["ctas_per_sm"] * sms)
    print(f"[C] K2 staged grid {n_cta} CTAs x {sched['threads']} threads ({sched['channels']} "
          f"channels of one batch row each), ring of {sched['stages']} stages x "
          f"{sched['steps_per_stage']} steps, {sched['smem_bytes']} B dynamic shared memory per "
          f"CTA, {sched['ctas_per_sm']} CTAs resident per SM x {sms} SMs: {waves:.3f} waves, "
          f"{n_cta / sms:.3f} CTAs per SM")
    rec["rglru_scan"] = dict(variant=k2_kind, ms=ms, staged_ms=times["staged"],
                             simple_ms=simple_ms, simple_runs_ms=times["simple"],
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             grid=n_cta, schedule=sched)
    del args
    free()

    # K2 at recurrentgemma-9b's decode shape: one step from the carried h0,
    # in a CUDA graph of GRAPH_CALLS launches (the entry point takes the
    # simple kernel there; the staged one beside it), with the eager call
    args = scan_inputs(RG_BATCH, 1, RG_W, seed=12, with_h0=True)
    k2_kind = k2.variant(RG_BATCH, 1, RG_W)
    eager_ms = cuda_ms(lambda: k2.rglru_scan_kernel(*args), iters=200, warmup=5)
    graphs = {}
    for kind in ("staged", k2_kind):
        graphs[kind] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[kind]):
            for _ in range(GRAPH_CALLS):
                if kind == k2_kind:
                    k2.rglru_scan_kernel(*args)
                else:
                    k2.launch(kind, *args)
    graph_ms = {kind: [] for kind in graphs}
    for kind in (k2_kind, "staged", "staged", k2_kind):
        graph_ms[kind].append(cuda_ms(graphs[kind].replay, iters=10) / GRAPH_CALLS)
    ms = min(graph_ms[k2_kind])
    plain_ms = cuda_ms(lambda: ops.rglru_scan_ref(*args), iters=20, warmup=2)
    flops, nbytes = 2 * RG_BATCH * RG_W, 4 * RG_BATCH * RG_W * 4     # a, b, h0 read; h written
    b_ms, b_by = bound(flops, nbytes, fp32_peak, bw_peak)
    print(f"[C] K2 rglru_scan decode B={RG_BATCH} S=1 W={RG_W} f32 from h0: {k2_kind} "
          f"{', '.join(f'{t * 1e3:.2f}' for t in graph_ms[k2_kind])} us/call in a CUDA graph of "
          f"{GRAPH_CALLS}, staged {', '.join(f'{t * 1e3:.2f}' for t in graph_ms['staged'])} us; "
          f"{eager_ms * 1e3:.2f} us per eager call; bound {b_ms * 1e3:.3f} us ({b_by}; "
          f"{nbytes / 1e6:.3f} MB at {bw_peak / 1e12:.2f} TB/s); plain {plain_ms * 1e3:.2f} us "
          f"| card: {card}")
    rec["rglru_scan"]["at_decode"] = dict(
        variant=k2_kind, ms=ms, runs_ms=graph_ms[k2_kind], staged_ms=min(graph_ms["staged"]),
        eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del args, graphs
    free()

    for name, r in runs.items():
        print(f"[C] serving {name}: prefill {r['prefill_ms']:.3f} ms (first call, host clock), "
              f"warm prefill {r['warm_ms']:.3f} ms with the kernels, {r['plain_ms']:.3f} ms "
              f"with the plain forms (CUDA events); decode {r['tok_s']:.1f} tok/s; peak "
              f"memory {r['peak_gb']:.1f} GB | card: {card}")
    print(f"[C] smoke ran {time.perf_counter() - t_start:.1f} s after the card check")

    def launches(name):
        return sum(r["launches"][name] for r in runs.values())

    by_path = lambda name: {m: r["launches"][name] for m, r in runs.items() if r["launches"][name]}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention_sm90.cu",
             simt_source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:35",
             launches=launches("flash_attention"), launches_by_path=by_path("flash_attention"),
             max_abs_err=k1_err, **rec["flash_attention"]),
        dict(name="rglru_scan", route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan.py:27",
             launches=launches("rglru_scan"), launches_by_path=by_path("rglru_scan"),
             launches_by_variant={kind: sum(r["k2_by_variant"][kind] for r in runs.values())
                                  for kind in k2.ENTRIES},
             max_abs_err=k2_err, **rec["rglru_scan"]),
        dict(name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
             replaces="src/repro/kernels/wkv6.py:27",
             launches=launches("wkv6"), launches_by_path=by_path("wkv6"),
             max_abs_err=k3_err, **rec["wkv6"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
