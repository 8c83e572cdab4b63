#!/usr/bin/env python3
"""Where a served model's prefill and decode steps spend the card's time.

    python3 tools/profile_serving.py --arch whisper-large-v3 --batch 16 --prompt 224
    python3 tools/profile_serving.py --arch yi-34b --layers 12 --batch 4 --prompt 2048

Needs one CUDA card (sm_90a) and ``nvcc`` (the port's kernels are built at
their first launch).  Builds the architecture at its published widths
(``--layers`` cuts the depth) with bf16 weights from a seed, random prompts
(and, for an encoder-decoder, random frames), and runs the serving path's
``Model.prefill`` and ``Model.decode_step`` as ``launch.serve`` does.  After
two warm calls it times one prefill, and ``--decode-steps`` decode steps, by
CUDA events without the profiler, then runs the same calls again under
``torch.profiler`` and sums the device time of every kernel by category:
the port's kernels (K1, K2, K3), cuBLAS matrix products, and the rest
(elementwise passes, reductions, copies).  The device's idle share is one
less the kernels' summed time over the unprofiled wall time (one stream,
so kernels do not overlap).  Prints the top kernels by device time, one
line per category, the card's name and power limit, and one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CATEGORIES = (("flash_fwd", "K1 flash attention"), ("rglru", "K2 rglru_scan"),
              ("wkv6", "K3 wkv6"))
MATMUL_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
TOP = 12


def category(kernel: str) -> str:
    name = kernel.lower()
    for mark, label in CATEGORIES:
        if mark in name:
            return label
    if any(mark in name for mark in MATMUL_MARKS):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_kernels(torch, fn):
    """{kernel name: (ms, launches)} of ``fn``'s device work, by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (us / 1e3, evt.count)
    return out


def report(tag: str, wall_ms: float, kernels, card: str) -> dict:
    busy = sum(ms for ms, _ in kernels.values())
    by_cat = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in kernels.items():
        by_cat[category(name)][0] += ms
        by_cat[category(name)][1] += n
    print(f"[{tag}] wall {wall_ms:.3f} ms (CUDA events, no profiler); device busy "
          f"{busy:.3f} ms in {sum(n for _, n in kernels.values())} kernel launches; idle "
          f"share {max(0.0, 1 - busy / wall_ms):.3f} | card: {card}")
    for label, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {label:42s} {ms:10.3f} ms {100 * ms / busy:5.1f} % of busy, "
              f"{n} launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"[{tag}]     {ms:9.3f} ms x{n:<5d} {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=max(0.0, 1 - busy / wall_ms),
                by_category={k: dict(ms=v[0], launches=v[1]) for k, v in by_cat.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-large-v3")
    ap.add_argument("--layers", type=int, default=None, help="cut the decoder's depth")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=224)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    dev = resolve_device("cuda")
    card = card_line()
    full = get_config(args.arch)
    cfg = dataclasses.replace(full, n_layers=args.layers or full.n_layers,
                              param_dtype="bfloat16")
    model = init_params(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), generator=gen,
                            device=dev)
    frames = None
    if cfg.is_encdec:
        frames = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                             device=dev).bfloat16()
    s_buf = args.prompt + 4 + 2 * args.decode_steps
    print(f"[setup] {cfg.name}: {cfg.n_layers} of {full.n_layers} decoder layers"
          f"{f', {cfg.encoder_layers} encoder layers and {cfg.encoder_seq} frames' if cfg.is_encdec else ''}"
          f", batch {args.batch}, prompt {args.prompt}, bf16 | card: {card}")

    def prefill():
        return model.prefill(prompts, s_buf, frames=frames)

    for _ in range(2):
        logits, cache = prefill()
    pre = report("prefill", event_ms(torch, prefill), device_kernels(torch, prefill), card)

    logits, cache = prefill()
    tok = logits[:, -1:].argmax(-1)
    pos = [args.prompt]

    def decode():
        for _ in range(args.decode_steps):
            model.decode_step(tok, pos[0], cache)
            pos[0] += 1

    decode()                      # warm
    wall = event_ms(torch, decode)
    dec = report(f"decode x{args.decode_steps}", wall, device_kernels(torch, decode), card)
    print(f"[decode] {wall / args.decode_steps:.3f} ms per step, "
          f"{args.batch * args.decode_steps / (wall / 1e3):.1f} tok/s | card: {card}")
    print(card)
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
                      "prompt": args.prompt, "card": card, "prefill": pre,
                      "decode": dict(dec, steps=args.decode_steps)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
