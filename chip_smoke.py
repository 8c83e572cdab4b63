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
         f32 1e-5, TF32 off): K1 (flash attention; each case prints the
         kernel its dtype and head size choose: ``"wgmma"``, the tensor-core
         kernel, for bf16 at d_head 64, 128 and 256, ``"simt"`` otherwise;
         also at d_head 256 with 16 query heads on one KV head and a window;
         at gemma2-27b's heads, 32 on 16 KV heads with softcap 50 and query
         scale 144^-0.5, with and without a window, and mixtral-8x7b's, 32
         on 8 with a window, fp32 at S=1000 and window 384; at
         whisper-large-v3's, 20 of 64 with no GQA, bf16 and fp32: causal at
         S=224, non-causal at S=1500 (a ragged last key tile of 92) and
         cross, 224 queries on 1500 keys; one Sq != Sk non-causal case at
         d_head 128 and one at 256; K1's serving shapes are checked in C),
         K3 (WKV6, y and the final state,
         T = 1 from a state, ragged T, d_head 32: two blocks of value columns
         per head, with B*H = 21, and rwkv6-3b's serving shape) and K2
         (RG-LRU scan, equal to the plain loop bit for bit, also at
         recurrentgemma-9b's serving shape; each case prints the kernel its shape chooses:
         ``"staged"``, a and b staged by TMA, for S > 1 with W % 4 == 0,
         ``"simple"`` otherwise; from h0, S = 1, ragged S and W) and K4
         (the Mamba-2 decode step: 3 consecutive steps at Nemotron-H's
         decode shape, batch 32, 256 heads of 64 in 8 groups of state 256,
         bf16, z, xbc and dt strided slices of one in-projection row, and at
         batch 3 in fp32: the output every step, the fp32 SSM state to 1e-4
         and the conv state bit for bit; then its time at the decode shape,
         its bound and the plain form's);
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
             prefill;
           nemotron-h-47b at published widths, layers 49-60 of its
             published pattern (2 attention, 5 Mamba-2, 5 MLP layers),
             batch 32, prompt 1020 (the benchmark cell's): K1 once per
             attention layer per prefill, K4 once per Mamba-2 layer per
             decode step.
         Every kernel's launch count (K1-K4) is set to 0 just before a model is
         served and read just after, every K1 launch must have gone
         through ``"wgmma"``, and K2's launches split by kernel: the
         prefill's on ``"staged"``, the decode steps' on ``"simple"``; the
         session must report one window per
         round; the prefill's last-position logits must agree with a prefill
         through the models' plain forms (``transformer.PLAIN``) on the same
         weights (bf16: rtol 5e-2, atol 1e-1 times the logits' rms where
         that exceeds 1, as for recurrentgemma's tied embedding); each
         model prints its depth, parameters and weight bytes;
  C      CUDA-event timings at the serving shapes: each kernel, its plain
         version, its bound and, for K1, a library yardstick the port never
         calls (``F.scaled_dot_product_attention``; for gemma2-27b's softcap
         a compiled ``flex_attention``; no single PyTorch call computes K2's
         or K3's recurrence), and K1's SIMT kernel at the same bf16 shapes as
         the time before the tensor-core kernel; K1 also at gemma2-27b's
         global and local and mixtral-8x7b's prefill shapes (B=2, S=8192,
         so the 4096 window excludes pairs), with the models' q-chunked
         plain form as the plain version there; at every K1 shape the
         kernel's output and the yardstick's are first held against the
         plain version's on the timed inputs (bf16 2e-2); K1 also at
         whisper-large-v3's three shapes (B=16, 20 heads of 64): the
         encoder's 1500 frames on 1500, the cross-attention's 224 queries on
         1500 frames (non-causal, yardstick SDPA without a mask) and the
         decoder's causal 224; K2's staged
         and simple kernels alternated at recurrentgemma-9b's prefill shape
         (the simple one is the time before), with TB/s, the grid and the
         staged kernel's compiled schedule; K2 and K3 also at their decode
         shapes (S = 1 from h0, T = 1 from a state; device time over a CUDA
         graph, since an eager call costs the host more), with K3's grid and
         compiled schedule (CTAs resident per SM) printed; K1 also at the
         prefill shape (2 x 2048, causal) of moonshot-v1-16b-a3b,
         nemotron-4-15b, qwen1.5-110b and pixtral-12b;
  D      training, which runs none of the kernels (they have no backward; the
         reference trains through its plain forms too):
           1. one train step of the reduced yi-34b (d_model 256) on the card
              and on the CPU from the same seeded weights, fp32 compute, TF32
              off: loss and grad_norm agree within 1e-4 relative;
           2. ``repro_torch.launch.train.run`` (what ``main`` runs) on the
              command line ``--arch yi-34b --full-width --layers 4 --batch 2
              --seq 2048 --steps 6 --analyze-every 3 --policies all``
              (published widths, fp32 parameters and AdamW state, bf16
              compute; cut to 2 layers, and said so, if 4 do not fit) with
              every kernel's launch count set to 0 just before and required
              to be 0 just after; every loss and grad_norm finite, two
              analysis windows that name their regions; printed: warm step
              time (median and range of steps 2-6, CUDA events), tokens/s,
              model FLOP/s and their share of the bf16 peak, AdamW's share of
              the step, peak memory;
           3. checkpoints at reduced width: a run saves at step 2 through
              ``AsyncCheckpointer``; the arrays restored onto the card equal
              the saved ones bit for bit; ``--resume`` to step 4 gives the
              losses of an uninterrupted 4-step run within 1e-5 relative;
           4. bf16 checkpoints: ``train.run`` on mixtral-8x7b at published
              widths cut to 1 layer (bf16 parameters, the fp32 master and
              fp32 moments), batch 1 x 8192 (so each q-chunk of ``mha``
              scores its KV band of 4096 + 512 of the 8192 keys), 2 steps
              with ``--ckpt-dir`` (a temporary directory in the checkout,
              removed after; the disk's free space printed first and
              required for two checkpoints) and ``--ckpt-every 2``; the
              checkpoint (bf16 leaves as numpy ``V2``) restored into a fresh
              state on the card equals the saved tensors in dtype and bits;
              the restored state is saved again over step 2 (the timed
              save); ``--resume`` to step 4 gives the losses of an
              uninterrupted 4-step run within 1e-5 relative; printed: the
              arrays, GB, save and restore seconds, the warm step, peak
              memory and how many final tensors the two runs share bit for
              bit;
  E      the serving path as in B on this slice's families, bf16 weights
         from the seed, each at published widths: mixtral-8x7b (MoE, window
         4096) cut to 16 of 32 layers, batch 2, prompt 8192; gemma2-27b at
         full depth (46 layers: sandwich norms, softcap 50, window 4096 on
         the local half), batch 2, prompt 8192; moonshot-v1-16b-a3b,
         nemotron-4-15b and pixtral-12b cut to 4 layers and qwen1.5-110b to
         2, batch 2, prompt 2048.  K1 launches once per attention layer per
         prefill, every launch on "wgmma", K2 and K3 never; the checks of B,
         and for pixtral-12b also a prefill with random patches, kernels
         against the plain forms;
  F      the serving path as in B on whisper-large-v3, the encoder-decoder,
         at published widths and full depth (32 encoder and 32 decoder
         layers, d_model 1280, 20 heads of 64), bf16 weights from the seed,
         batch 16, prompt 224, 1500 random bf16 frames drawn by the server:
         K1 96 times per prefill (each encoder layer, each decoder layer's
         self- and cross-attention), every launch on "wgmma", K2 and K3
         never; 3 windows; kernel vs plain logits on the same frames; prints
         cold and warm prefill, decode tok/s and peak memory;
  G      the analysis side, which launches no kernel (every count set to 0
         before the phase and required to be 0 after it):
           1. the paper's case studies through the port's workloads, on the
              host CPU: ST (original, balanced, locality + buffered I/O) and
              NPAR1WAY (original, optimized) at scale 0.4 on the fixed taus
              of ``tests/test_torch_workloads.py``, which must give the
              paper's verdicts (ST: kinds {0} {1,2} {3} {4,6} {5,7}, CCCR
              ext 11, int {8, 11}, cores {instructions} / {disk_io,
              l2_miss_rate}; NPAR1WAY: one cluster, CCCRs {3, 12}, core
              {instructions, network_io}); then each counterpart of
              ``examples/*_case_study.py`` once at scale 1.0 on its own
              calibration, printing its report and ladder;
           2. ``train.run`` on D.2's command line (its depth) with ``--steps
              9 --sim-ranks 8 --chaos-seed 3 --chaos-hosts 2 --diagnosis
              learned``: 3 windows, the forced analyzer fault a supervised
              tombstone at window 1, host 1's truncated blob quarantined
              (its ranks gap-masked) at window 2, finite losses, every
              window diagnosed by the learned strategy; then a reduced-width
              run with ``--pod-gather`` that must deliver every window;
           3. transport: two processes on the card's host in one gloo group
              gather seeded windows with ``SnapshotCollector``, and the
              merged bytes must equal ``merge_blobs`` of both blobs in one
              process; one NCCL group of world size 1 on the card moves a
              blob through ``SnapshotCollector._allgather`` on the device;
  H      measured step costs, mesh, sharding and runtime, which launch no
         kernel (every count set to 0 before the phase and required to be 0
         after it):
           1. ``train.run`` on D.2's command line with ``--schema tpu`` (so
              ``--costs hlo``): the step's flops, HBM and collective bytes
              counted once on the meta device before the first step; the
              counted matmul flops within 2 % of ``model_flops`` plus
              ``remat_flops``, the warm step within 5 % of D.2's, the
              recorded step attributes those of the counted provider;
           2. the count of one train step of the full yi-34b (60 layers) at
              the reference's train_4k shape (256 x 4096, 4 microbatches) on
              the meta device, with no device memory: flops, HBM bytes and
              their intensity against the H100 ridge;
           3. ``make_host_mesh`` over an NCCL world of one on the card and
              one ``runtime.constrain`` of a CUDA DTensor inside
              ``sharding_context`` (the resolved placements, the values
              unchanged); a (2, 16, 16) production mesh over a fake world
              of 512 with one resolved placement's local shape;
  I      the multi-pod dry-run and its roofline, which launch no kernel:
         ``python -m repro_torch.launch.dryrun`` as processes side by side
         (each a fake process group of 256 or 512, every tensor on the meta
         device) for yi-34b train_4k on the single- and the two-pod mesh,
         mixtral-8x7b prefill_32k, qwen1.5-110b decode_32k (FSDP kept by
         ``serve_rules``), recurrentgemma-9b long_500k (batch 1: the cache's
         sequence takes ``data``) and the skipped yi-34b long_500k, then
         ``python -m repro_torch.launch.roofline`` over their records.
         Every record is ``ok`` or skipped with the registry's reason; the
         two-pod yi-34b train_4k matmul flops per device are half the
         single pod's (1 %); the single pod's x 256 equal H.2's unsharded
         count plus the padded heads' attention products (56 heads padded
         to 64: 8/56 of H.2's batched products, the attention's; every
         other product is split 256 ways), within 1 %; the roofline prints
         one row per counted cell; mixtral-8x7b prefill_32k's matmul flops
         per device equal ``banded_prefill_flops``, the closed form with each
         q-chunk's attention over its KV band of 4096 + 512 keys (1 %).  Each
         cell's count time, per-device flops, bytes, collective bytes by kind
         and three terms are printed.

The last lines are the card's name and power limit, one JSON line of kernel
records, and the verdict ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
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
# phase E: (arch, layers or None for full depth, batch, prompt)
E_MODELS = (("mixtral-8x7b", 16, 2, 8192), ("gemma2-27b", None, 2, 8192),
            ("moonshot-v1-16b-a3b", 4, 2, 2048), ("nemotron-4-15b", 4, 2, 2048),
            ("qwen1.5-110b", 2, 2, 2048), ("pixtral-12b", 4, 2, 2048))
E_BATCH, E_PROMPT, E_WINDOW = 2, 8192, 4096        # mixtral's and gemma2's prefill shape
G2_H, G2_KH, G2_SOFTCAP, G2_SCALE = 32, 16, 50.0, 144.0 ** -0.5   # gemma2-27b attention
G2_KW = dict(causal=True, softcap=G2_SOFTCAP, scale=G2_SCALE)
MX_H, MX_KH = 32, 8              # mixtral-8x7b attention
# phase F and whisper's K1 shapes: batch, prompt, 20 heads of 64, 1500 frames
WH_BATCH, WH_PROMPT, WH_H, WH_DH, WH_FRAMES = 16, 224, 20, 64, 1500
GRAPH_CALLS = 50                 # K2 or K3 launches per CUDA graph at the decode shape
# Nemotron-H-47B: K4 at the Mamba-2 decode shape of the benchmark's cell
# (batch 32; 256 heads of 64 in 8 groups of state 256), and phase B's cut
# of the published pattern: layers 49-60 (the cell's first twelve), 2
# attention, 5 Mamba-2 and 5 MLP layers, served at the cell's batch and prompt
NH_BATCH, NH_PROMPT, NH_H, NH_P, NH_G, NH_N = 32, 1020, 256, 64, 8, 256
NH_LAYERS = slice(49, 61)
K4_STEPS = 3                     # consecutive state updates per phase A case
K4_TOL = {"bfloat16": dict(rtol=1e-2, atol=1e-2), "float32": dict(rtol=1e-4, atol=1e-4)}
TRAIN_LAYERS, TRAIN_FALLBACK_LAYERS = 4, 2
TRAIN_ARGV = ["--arch", "yi-34b", "--full-width", "--batch", "2", "--seq", "2048",
              "--steps", "6", "--analyze-every", "3", "--policies", "all"]
TRAIN_SMALL = ["--arch", "yi-34b", "--d-model", "256", "--batch", "2", "--seq", "128"]
TRAIN_RTOL = 1e-4                # card against CPU, one fp32 step
RESUME_RTOL = 1e-5               # resumed against uninterrupted losses
# D.4: mixtral-8x7b at published widths cut to one layer, bf16 parameters and
# the fp32 master; 8192 tokens, so each q-chunk of 512 scores the band of
# 4096 + 512 keys
D4_ARGV = ["--arch", "mixtral-8x7b", "--full-width", "--layers", "1", "--batch", "1",
           "--seq", "8192", "--analyze-every", "2"]
D4_CKPT_BYTES = 2 + 4 + 4 + 4    # per parameter: bf16 weight, fp32 master, m, v
D4_DISK_MARGIN = 4e9             # bytes free beyond two checkpoints
# phase G: the case studies at tests/test_case_studies.py's scale on fixed taus
# (seconds per unit of work), so no clock decides their verdicts; the tests of
# tests/test_torch_workloads.py read these.  ST's (tau_con, tau_str, tau_blk)
# and NPAR1WAY's per-call costs come from one calibration run of the
# reference at G_SCALE on the CPU whose verdict was the paper's.  ST's
# internal verdict turns on tau_str / tau_con (here 3.81): it holds up to
# ~4.6 and gives CCCRs {14, 11} from ~4.75 on.
G_SCALE = 0.4
ST_TAUS = (2.64e-4, 1.007e-3, 5.67e-4)
NPAR_TAUS = {"sort": 8.0e-4, "score_red": 4.9e-3, "score_hoist": 5.0e-4,
             "score12": 2.3e-4, "pickle": 2.3e-4}
ST_KINDS = ((0,), (1, 2), (3,), (4, 6), (5, 7))
G_CHAOS = ["--steps", "9", "--sim-ranks", "8", "--chaos-seed", "3", "--chaos-hosts", "2",
           "--diagnosis", "learned", "--policies", "all"]
G_POD = TRAIN_SMALL + ["--steps", "6", "--analyze-every", "3", "--pod-gather"]
G_GATHER_WINDOWS = 3             # windows each gloo process gathers in G.3
# phase C: K1 at the prefill shape of phase E's models served at 2 x 2048
C_SMALL_ARCHS = ("moonshot-v1-16b-a3b", "nemotron-4-15b", "qwen1.5-110b", "pixtral-12b")
C_SMALL_BATCH, C_SMALL_PROMPT = 2, 2048
# phase H: D.2's run under --schema tpu (so --costs hlo); the count of one
# step of the full yi-34b at the reference's train_4k shape (global batch
# 256 x 4096, yi-34b's 4 microbatches: repro/configs/__init__.py:37,46)
H_ARGV = ["--schema", "tpu"]
H2_BATCH, H2_SEQ, H2_MICROBATCHES = 256, 4096, 4
H_FLOPS_RTOL = 0.02              # counted matmul flops against the closed form
# phase I: the dry-run's cells (arch, shape, mesh), each a process of its own
I_CELLS = (("yi-34b", "train_4k", "single"), ("yi-34b", "train_4k", "multi"),
           ("mixtral-8x7b", "prefill_32k", "single"), ("qwen1.5-110b", "decode_32k", "single"),
           ("recurrentgemma-9b", "long_500k", "single"), ("yi-34b", "long_500k", "single"))
I_RTOL = 0.01                    # two-pod vs single-pod, sharded vs unsharded matmul flops
I_TIMEOUT = 600                  # seconds for all of phase I's processes
H_STEP_RTOL = 0.05               # H.1's warm step against D.2's
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


def qkv(B, S, h, kh, dh, dtype, seed, Sk=None):
    """q (B, S, h, dh) and k, v (B, Sk, kh, dh); ``Sk`` defaults to ``S``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n, s: torch.randn((B, s, n, dh), generator=g, device="cuda").to(dtype)
    return mk(h, S), mk(kh, Sk or S), mk(kh, Sk or S)


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
    """K1 vs plain, case by case (the serving shapes are checked in C, on
    the inputs that are timed there).  S is an int, or (Sq, Sk) where the
    keys are not the queries (cross-attention)."""
    rg_kw = dict(causal=True, window=RG_WINDOW)
    full = dict(causal=False)
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
        # gemma2-27b's and mixtral-8x7b's heads on the SIMT kernel (fp32), the
        # window below S; their bf16 (wgmma) serving shapes are checked in C
        ("gemma2 global", 2, 1000, G2_H, G2_KH, DH, "float32", G2_KW),
        ("gemma2 local", 2, 1000, G2_H, G2_KH, DH, "float32", dict(G2_KW, window=384)),
        ("mixtral", 2, 1000, MX_H, MX_KH, DH, "float32", dict(causal=True, window=384)),
        # whisper-large-v3's heads (20 of 64, no GQA): the decoder's causal
        # self-attention, the encoder's full attention over 1500 frames (the
        # last 128-key tile holds 92) and the cross-attention, 224 queries
        # against 1500 frames; bf16 on wgmma, fp32 on SIMT
        ("whisper self", 2, WH_PROMPT, WH_H, WH_H, WH_DH, "bfloat16", dict(causal=True)),
        ("whisper self", 2, WH_PROMPT, WH_H, WH_H, WH_DH, "float32", dict(causal=True)),
        ("whisper enc", 2, WH_FRAMES, WH_H, WH_H, WH_DH, "bfloat16", full),
        ("whisper enc", 2, WH_FRAMES, WH_H, WH_H, WH_DH, "float32", full),
        ("whisper cross", 2, (WH_PROMPT, WH_FRAMES), WH_H, WH_H, WH_DH, "bfloat16", full),
        ("whisper cross", 2, (WH_PROMPT, WH_FRAMES), WH_H, WH_H, WH_DH, "float32", full),
        # Sq != Sk at the other wgmma head sizes
        ("Sq!=Sk dh=128", 2, (300, 1000), 14, 2, DH, "bfloat16", full),
        ("Sq!=Sk dh=256", 2, (1000, 333), RG_H, RG_KH, RG_DH, "bfloat16", full),
    ]
    for i, (name, B, S, h, kh, dh, dt, kw) in enumerate(cases):
        S, Sk = S if isinstance(S, tuple) else (S, S)
        q, k, v = qkv(B, S, h, kh, dh, getattr(torch, dt), seed=100 + i, Sk=Sk)
        kind = fa.variant(q.dtype, dh)
        before = fa.flash_attention.launches_by_variant[kind]
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if fa.flash_attention.launches_by_variant[kind] != before + 1:
            raise RuntimeError(f"K1 {name}: no launch of the {kind!r} kernel counted")
        want = ops.attention_ref(q, k, v, **kw)
        e = (got.float() - want.float()).abs().max().item()
        print(f"[A] K1 {name:14s} B={B} S={S} Sk={Sk} H={h} K={kh} dh={dh} {dt:8s} "
              f"{kind:5s} {kw}: max|err|={e:.3e} tol={TOL[dt]}")
        torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
        del q, k, v, got, want
        free()


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


def k4_case(torch, k4, batch, dtype, seed):
    """K4's arguments at Nemotron-H's widths as the decode step passes them
    (the fp32 state, the conv state, the layer's weights) and a function
    that draws the next token's in-projection row and returns z, xbc and
    dt as its column slices, with the row's stride."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device="cuda")).to(dtype)

    H, P, G, N = NH_H, NH_P, NH_G, NH_N
    conv = H * P + 2 * G * N
    state = torch.randn((batch, H, P, N), generator=g, device="cuda")
    weights = dict(conv_w=rnd(conv, k4.TAPS, std=0.5), conv_b=rnd(conv, std=0.1),
                   dt_bias=rnd(H), A_log=rnd(H, std=2.0), D=rnd(H),
                   norm_scale=rnd(H * P, std=0.1))

    def row():
        z, xbc, dt = rnd(batch, H * P + conv + H).split([H * P, conv, H], dim=-1)
        return dict(z=z, xbc=xbc, dt=dt)

    return state, rnd(batch, conv, k4.TAPS - 1), weights, row


def phase_a_ssm_state_update(torch, ops, k4, rates, card):
    """K4 vs ``ops.ssm_state_update_ref``: K4_STEPS consecutive decode steps
    from the same states, z, xbc and dt strided slices of one row, at the
    cell's decode shape in bf16 and at batch 3 in fp32; the output every
    step, the SSM state (fp32, 1e-4) and the conv state (bit for bit) after
    the last.  Then its CUDA-event time at the decode shape, its bound and
    the plain form's; returns the record."""
    fp32_peak, bw_peak = rates
    err = None
    for i, (name, batch, dt) in enumerate((("decode nemotron-h", NH_BATCH, "bfloat16"),
                                           ("batch 3", 3, "float32"))):
        state, cstate, w, row = k4_case(torch, k4, batch, getattr(torch, dt), seed=400 + i)
        plain_state, plain_cstate, start = state.clone(), cstate.clone(), state.clone()
        eo = 0.0
        for _ in range(K4_STEPS):
            r = row()
            before = k4.ssm_state_update_kernel.launches
            got = k4.ssm_state_update_kernel(state, cstate, **r, **w)
            torch.cuda.synchronize()
            if k4.ssm_state_update_kernel.launches != before + 1:
                raise RuntimeError(f"K4 {name}: no launch counted")
            want = ops.ssm_state_update_ref(plain_state, plain_cstate, **r, **w)
            eo = max(eo, (got.float() - want.float()).abs().max().item())
            torch.testing.assert_close(got.float(), want.float(), **K4_TOL[dt])
        es = (state - plain_state).abs().max().item()
        moved = (plain_state - start).abs().max().item()
        print(f"[A] K4 {name:17s} B={batch} H={NH_H} P={NH_P} G={NH_G} N={NH_N} {dt:8s} "
              f"{K4_STEPS} steps: out max|err|={eo:.3e} tol={K4_TOL[dt]}; state "
              f"max|err|={es:.3e} tol={K4_TOL['float32']} (the steps moved it by up to "
              f"{moved:.3e}); conv state bit for bit: {torch.equal(cstate, plain_cstate)}")
        torch.testing.assert_close(state, plain_state, **K4_TOL["float32"])
        if not torch.equal(cstate, plain_cstate):
            raise RuntimeError(f"K4 {name}: the conv state differs from the plain form's")
        if batch == NH_BATCH:
            err = eo
        del state, cstate, w, plain_state, plain_cstate, start, got, want
        free()

    state, cstate, w, row = k4_case(torch, k4, NH_BATCH, torch.bfloat16, seed=402)
    r = row()
    ms = cuda_ms(lambda: k4.ssm_state_update_kernel(state, cstate, **r, **w), iters=20)
    plain_ms = cuda_ms(lambda: ops.ssm_state_update_ref(state, cstate, **r, **w), iters=5,
                       warmup=1)
    conv = NH_H * NH_P + 2 * NH_G * NH_N
    flops = 4 * NH_BATCH * NH_H * NH_P * NH_N
    nbytes = (2 * state.numel() * 4                  # the state read and written, fp32
              + NH_BATCH * (conv + NH_H * NH_P) * 4  # x, B, C read; y written (fp32)
              + r["dt"].numel() * 2)                 # dt (bf16)
    b_ms, b_by = bound(flops, nbytes, fp32_peak, bw_peak)
    print(f"[C] K4 ssm_state_update decode B={NH_BATCH} H={NH_H} P={NH_P} G={NH_G} "
          f"N={NH_N} bf16: {ms:.4f} ms/call (conv step, state update, gated norm; "
          f"{nbytes / ms / 1e9:.3f} TB/s); bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.3f} GB "
          f"at {bw_peak / 1e12:.2f} TB/s; {flops / 1e9:.2f} GFLOP); plain {plain_ms:.4f} ms; "
          f"library: no single PyTorch call | card: {card}")
    del state, cstate, w, r
    free()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err)


def check_logits(torch, tag, got, plain):
    """Kernel-path logits against the plain forms' within LOGITS_TOL, the
    absolute part scaled by the logits' rms where it exceeds 1."""
    lerr = (plain - got).abs().max().item()
    agree = (plain.argmax(-1) == got.argmax(-1)).float().mean().item()
    # tied embeddings give logits of rms ~sqrt(d_model) where untied ones
    # have rms ~1: the absolute tolerance is taken relative to the rms
    rms = plain.pow(2).mean().sqrt().item()
    tol = dict(LOGITS_TOL, atol=LOGITS_TOL["atol"] * max(1.0, rms))
    print(f"{tag}, kernels vs plain forms: max|err|={lerr:.3e} (logits rms {rms:.3f}) "
          f"tol={tol}; greedy-token agreement {agree:.3f}")
    torch.testing.assert_close(got, plain, **tol)


def serve_model(torch, cfg, batch, prompt, counters, expected, phase="B", patches=False):
    """Phase B (E, F) for one model: serve it with every launch count set
    to 0 just before, check the counts (K2's by kernel: the prefill's
    staged, the decode steps' simple), windows, tokens and the
    kernel-vs-plain prefill logits (an encoder-decoder's on the frames the
    server drew; with ``patches``, also of a prefill with random
    vision-stub patches); returns the counts and the timings."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import PLAIN

    tag = f"[{phase}]"
    print(f"{tag} serving {cfg.name} at full width (d_model={cfg.d_model}, "
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
    n_params = sum(p.numel() for p in res.model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in res.model.parameters())
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.2f} B parameters, "
          f"{weight_bytes / 1e9:.2f} GB of {cfg.param_dtype} weights")
    rec_layers = cfg.layer_kinds.count("rec")
    k2_expected = dict(staged=rec_layers, simple=rec_layers * ROUNDS * TOKENS)
    print(f"{tag} {cfg.name}: launches {launches}, expected {expected}; K1 by kernel "
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
        print(f"{tag} {cfg.name} window {w.title()}: internal bottlenecks {cccrs or ['(none)']}")
    if res.tokens.shape != (batch, 1 + ROUNDS * TOKENS):
        raise RuntimeError(f"decoded tokens have shape {res.tokens.shape}")
    if not torch.isfinite(res.prefill_logits).all():
        raise RuntimeError("non-finite prefill logits")
    s_buf = prompt + ROUNDS * TOKENS
    (plain_logits, _), plain_ms = timed(lambda: res.model.prefill(
        res.prompts, s_buf, kernels=PLAIN, frames=res.frames))
    check_logits(torch, f"{tag} {cfg.name} prefill logits", res.prefill_logits, plain_logits)
    if patches:
        g = torch.Generator(device="cuda").manual_seed(3)
        pt = torch.randn((batch, cfg.n_patches, cfg.d_model), generator=g,
                         device="cuda").to(torch.bfloat16)
        with_patches, _ = res.model.prefill(res.prompts, s_buf, patches=pt)
        plain_patches, _ = res.model.prefill(res.prompts, s_buf, kernels=PLAIN, patches=pt)
        check_logits(torch, f"{tag} {cfg.name} prefill logits with {cfg.n_patches} random "
                     f"patches", with_patches, plain_patches)
        if torch.equal(with_patches, res.prefill_logits):
            raise RuntimeError(f"{cfg.name}: the patches changed no logit")
        del pt, with_patches, plain_patches
    del plain_logits
    warm_ms = cuda_ms(lambda: res.model.prefill(res.prompts, s_buf, frames=res.frames),
                      iters=2, warmup=1)
    out = dict(launches=launches, k1_by_variant=by_variant, k2_by_variant=k2_by_variant,
               layers=cfg.n_layers,
               params_b=n_params / 1e9, weight_gb=weight_bytes / 1e9,
               prefill_ms=res.prefill_s * 1e3, tok_s=res.decode_tok_s,
               warm_ms=warm_ms, plain_ms=plain_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del res
    free()
    return out


def nemotron_h_cut(full):
    """Nemotron-H-47B at its published widths, layers NH_LAYERS of its
    published pattern, bf16 weights."""
    kinds = full.block_pattern[NH_LAYERS]
    return dataclasses.replace(full, n_layers=len(kinds), block_pattern=kinds,
                               param_dtype="bfloat16")


def serve_nemotron_h(torch, cfg, counters):
    """B for the hybrid stack: served as the others at the cell's batch
    and prompt; K1 once per attention layer per prefill, K4 once per
    Mamba-2 layer per decode step (the prefill runs the chunked SSD), K2
    and K3 never."""
    kinds = cfg.layer_kinds
    print(f"[B] {cfg.name}: layers {NH_LAYERS.start}-{NH_LAYERS.stop - 1} of the published "
          f"pattern, published widths (state {cfg.ssm_heads} heads x {cfg.ssm_head_dim} x "
          f"{cfg.ssm_state}, {cfg.ssm_groups} groups)")
    return serve_model(torch, cfg, NH_BATCH, NH_PROMPT, counters, {
        "flash_attention": kinds.count("attn"), "rglru_scan": 0, "wkv6": 0,
        "ssm_state_update": kinds.count("mamba2") * ROUNDS * TOKENS})


def phase_e(torch, counters):
    """E: this slice's families through ``serve`` at published widths, each
    freed before the next; K1 once per attention layer per prefill, K2 and
    K3 never."""
    from repro_torch.configs import get_config

    runs = {}
    for arch, layers, batch, prompt in E_MODELS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers,
                                  param_dtype="bfloat16")
        print(f"[E] {arch}: depth {cfg.n_layers} of {full.n_layers} layers, published widths")
        attn_layers = sum(kind not in ("rec", "rwkv") for kind in cfg.layer_kinds)
        runs[cfg.name] = serve_model(
            torch, cfg, batch, prompt, counters,
            {"flash_attention": attn_layers, "rglru_scan": 0, "wkv6": 0,
             "ssm_state_update": 0}, phase="E",
            patches=cfg.frontend == "vision_stub")
    return runs


def phase_f(torch, counters):
    """F: whisper-large-v3 through ``serve`` at published widths and full
    depth (32 encoder and 32 decoder layers), bf16 weights from the seed,
    batch WH_BATCH, prompt WH_PROMPT, WH_FRAMES random frames drawn by the
    server: K1 once per encoder layer and twice per decoder layer (self-
    and cross-attention) per prefill, all on "wgmma"; K2 and K3 never."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("whisper-large-v3"), param_dtype="bfloat16")
    if cfg.encoder_seq != WH_FRAMES:
        raise RuntimeError(f"whisper's encoder_seq {cfg.encoder_seq} != {WH_FRAMES}")
    k1 = cfg.encoder_layers + 2 * cfg.n_layers
    print(f"[F] {cfg.name}: {cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers "
          f"(full depth), published widths, {WH_FRAMES} frames; K1 expected {k1} per prefill")
    return {cfg.name: serve_model(torch, cfg, WH_BATCH, WH_PROMPT, counters,
                                  {"flash_attention": k1, "rglru_scan": 0, "wkv6": 0,
                                   "ssm_state_update": 0}, phase="F")}


# Library yardsticks of K1, each ``(label, prepare)`` with ``prepare(q, k,
# v) -> call`` and ``call() -> (B, H, S, dh)``; the port never calls them.

def sdpa_causal(torch):
    """Causal GQA attention: one SDPA call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def prepare(q, k, v):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    return "SDPA (is_causal, enable_gqa)", prepare


def sdpa_full(torch):
    """Non-causal attention with as many KV heads as query heads (whisper's
    encoder and cross-attention): one SDPA call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def prepare(q, k, v):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: sdpa(qt, kt, vt)
    return "SDPA (non-causal)", prepare


def sdpa_band(torch, window):
    """Windowed GQA attention: one SDPA call with a band mask, K/V expanded
    to the query heads beforehand."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def prepare(q, k, v):
        pos = torch.arange(q.shape[1], device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(q.shape[2] // k.shape[2], dim=1)
                  for t in (k, v))
        return lambda: sdpa(qt, kt, vt, attn_mask=band)
    return f"SDPA with a {window}-wide band mask, K/V expanded", prepare


def flex_softcap(torch, softcap, scale, window=0):
    """gemma2's attention, softcap and all: one ``flex_attention`` call,
    compiled by ``torch.compile`` (the eager one materializes every score),
    with the softcap as its ``score_mod`` and the causal mask, banded to
    ``window`` when it is set, as its block mask.  The compile's caches go
    to the kernels' build directory."""
    import os

    from repro_torch.kernels import _build
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(_build.BUILD_DIR / sub))
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    flex = torch.compile(flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        return keep & (kv_idx > q_idx - window) if window else keep

    def prepare(q, k, v):
        mask = create_block_mask(mask_mod, None, None, q.shape[1], k.shape[1], device="cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=mask, scale=scale,
                            enable_gqa=True)
    band = f", {window}-wide band" if window else ""
    return f"compiled flex_attention (tanh softcap score_mod, causal{band} block mask)", prepare


def time_k1(torch, fa, shape, kw, plain, library, rates, card, seed, Sk=None):
    """C for K1 at one prefill shape ``(B, S, H, K, dh)`` (``Sk`` keys,
    default S), bf16: the entry point's kernel held against the plain
    version ``plain`` on the inputs it is timed on (bf16 tolerance), its
    time, the SIMT kernel's beside it (the time before wgmma), the plain
    version's, the bound (FLOPs of the unmasked (q, k) pairs at the bf16
    peak, or q, k, v and o once at HBM bandwidth) and the library yardstick
    ``library`` (``(label, prepare)``), whose output is held against the
    plain version too."""
    B, S, h, kh, dh = shape
    Sk = Sk or S
    peak_name, bf16_peak, bw_peak = rates
    q, k, v = qkv(B, S, h, kh, dh, torch.bfloat16, seed=seed, Sk=Sk)
    kind = fa.variant(q.dtype, dh)
    opts = {key: (round(val, 6) if isinstance(val, float) else val) for key, val in kw.items()}
    want = plain(q, k, v, **kw).float()
    got = fa.flash_attention(q, k, v, **kw).float()
    err = (got - want).abs().max().item()
    print(f"[C] K1 B={B} S={S} Sk={Sk} H={h} K={kh} dh={dh} bf16 {opts}: {kind} against the plain "
          f"version: max|err|={err:.3e} tol={TOL['bfloat16']}")
    torch.testing.assert_close(got, want, **TOL["bfloat16"])
    lib_label, lib_prepare = library
    call = lib_prepare(q, k, v)
    lib_out = call().transpose(1, 2).float()
    lib_err = (lib_out - want).abs().max().item()
    print(f"[C] K1 yardstick {lib_label} against the plain version: max|err|={lib_err:.3e} "
          f"tol={TOL['bfloat16']}")
    torch.testing.assert_close(lib_out, want, **TOL["bfloat16"])
    del got, want, lib_out
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=10)
    simt_ms = cuda_ms(lambda: fa.launch("simt", q, k, v, **kw), iters=2, warmup=1)
    plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), iters=2, warmup=1)
    window = kw.get("window", 0)
    if kw.get("causal", True):   # the causal shapes have Sk == S
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    else:
        pairs = S * Sk
    flops = 4 * B * h * dh * pairs
    nbytes = 2 * (2 * B * S * h * dh + 2 * B * Sk * kh * dh)
    b_ms, b_by = bound(flops, nbytes, bf16_peak, bw_peak)
    library_ms = cuda_ms(call, iters=10)
    print(f"[C] K1 flash_attention B={B} S={S} Sk={Sk} H={h} K={kh} dh={dh} bf16 {opts}: {kind} "
          f"{ms:.4f} ms/call ({flops / ms / 1e9:.1f} TFLOP/s), simt {simt_ms:.4f} ms "
          f"({flops / simt_ms / 1e9:.1f} TFLOP/s); bound {b_ms:.4f} ms ({b_by}; "
          f"{flops / 1e9:.1f} GFLOP at {peak_name} {bf16_peak / 1e12:.0f} TFLOP/s bf16, "
          f"{nbytes / 1e9:.3f} GB at {bw_peak / 1e12:.2f} TB/s); plain {plain_ms:.4f} ms; "
          f"library (a yardstick the port never calls): {lib_label} {library_ms:.4f} ms "
          f"| card: {card}")
    del q, k, v, call
    free()
    return dict(variant=kind, max_abs_err=err, ms=ms, simt_ms=simt_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, library=lib_label)


def phase_d_card_vs_cpu(torch, dev):
    """D.1: one train step of the reduced yi-34b on the card and on the CPU
    from the same seeded weights, fp32 compute, TF32 off."""
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(train.build_config(train.parse_args(TRAIN_SMALL)),
                              compute_dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=5, decay_steps=10)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got = {}
    for where in ("cpu", dev):
        state = steps.init_state(cfg, opt, seed=0, device="cpu")   # drawn on the CPU
        state["params"].to(where)
        state["opt"] = adamw.init(dict(state["params"].named_parameters()), opt)
        _, m = steps.make_train_step(cfg, opt)(state, {k: v.to(where) for k, v in batch.items()})
        got[str(where)] = (float(m["loss"]), float(m["grad_norm"]))
    (l_cpu, n_cpu), (l_gpu, n_gpu) = got["cpu"], got[str(dev)]
    gaps = abs(l_gpu - l_cpu) / abs(l_cpu), abs(n_gpu - n_cpu) / abs(n_cpu)
    print(f"[D] reduced yi-34b (d_model {cfg.d_model}, {cfg.n_layers} layers) one fp32 train "
          f"step: loss card {l_gpu:.7f} cpu {l_cpu:.7f}, grad_norm card {n_gpu:.7f} cpu "
          f"{n_cpu:.7f}; relative gaps {gaps[0]:.2e}, {gaps[1]:.2e} (tolerance {TRAIN_RTOL})")
    if max(gaps) > TRAIN_RTOL:
        raise RuntimeError(f"card and CPU train steps disagree: {got}")
    return gaps


def model_flops(cfg, batch, seq):
    """(FLOPs of one train step as counted, the count in words): 6 x the
    matmul parameters (every weight matrix, the logits included, the
    embedding lookup not) x tokens, plus 12 x B x S^2 x H x dh per layer for
    QK^T and PV forward and backward over the full S x S scores the plain
    attention computes; the remat recompute is not counted."""
    d, H, K, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    per_layer = d * H * dh + 2 * d * K * dh + H * dh * d + 3 * d * f
    n_matmul = cfg.n_layers * per_layer + d * cfg.vocab_size
    tokens = batch * seq
    attn = 12 * cfg.n_layers * batch * seq * seq * H * dh
    return 6 * n_matmul * tokens + attn, (
        f"6 x {n_matmul / 1e9:.3f} B matmul parameters x {tokens} tokens + "
        f"12 x L x B x S^2 x H x dh attention = {6 * n_matmul * tokens / 1e12:.2f} + "
        f"{attn / 1e12:.2f} TFLOP")


def remat_flops(cfg, batch, seq):
    """(matmul FLOPs that remat adds to ``model_flops``, in words), as the
    port's training step runs them (``torch.utils.checkpoint``, which stops
    a recompute once the backward has what it needs): every layer's forward
    once more but its last matmul (the MLP's out-projection, whose output no
    backward reads), QK^T a third time where ``mha`` checkpoints its
    q-chunks inside the layer's (S > 512), and each loss chunk's logits
    where the loss has several chunks (S > 512)."""
    d, H, K, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    per_layer = d * H * dh + 2 * d * K * dh + H * dh * d + 3 * d * f
    tokens = batch * seq
    linear = 2 * cfg.n_layers * (per_layer - f * d) * tokens
    attn = (6 if seq > 512 else 4) * cfg.n_layers * batch * seq * seq * H * dh
    logits = 2 * d * cfg.vocab_size * tokens if seq > 512 else 0
    return linear + attn + logits, (
        f"2 x L x (layer matmul parameters - the MLP out-projection) x tokens + "
        f"{6 if seq > 512 else 4} x L x B x S^2 x H x dh + 2 x d x V x tokens = "
        f"{linear / 1e12:.2f} + {attn / 1e12:.2f} + {logits / 1e12:.2f} TFLOP")


def phase_d_full_width(torch, dev, counters, card, bf16_peak):
    """D.2: the trainer at yi-34b's published widths, no kernel launched."""
    from repro_torch.launch import train

    def attempt(layers):
        for fn in counters.values():
            fn.launches = 0
        res = train.run(TRAIN_ARGV + ["--layers", str(layers)])
        return res, {name: fn.launches for name, fn in counters.items()}

    layers, cut = TRAIN_LAYERS, ""
    try:
        res, launches = attempt(layers)
    except torch.cuda.OutOfMemoryError as e:
        free()
        cut = (f" (cut from {TRAIN_LAYERS} layers, which did not fit: "
               f"{str(e).splitlines()[0]})")
        layers = TRAIN_FALLBACK_LAYERS
        res, launches = attempt(layers)
    print(f"[D] yi-34b full width x{layers} layers{cut}: kernel launches {launches} "
          f"(all must be 0)")
    if any(launches.values()):
        raise RuntimeError(f"training launched kernels: {launches}")
    bad = [x for x in res.losses + res.grad_norms if not math.isfinite(x)]
    if bad or len(res.losses) != 6:
        raise RuntimeError(f"losses {res.losses}, grad norms {res.grad_norms}")
    windows = res.report.windows
    if len(windows) != 2:
        raise RuntimeError(f"{len(windows)} analysis windows, expected 2")
    for w in windows:
        named = [res.tree.name(r) for r in w.report.internal.cccrs]
        if w.failed or not named:
            raise RuntimeError(f"window {w.title()} failed or names no region")
        print(f"[D] window {w.title()}: internal bottlenecks {named}")
    warm = res.step_ms[1:]
    med = statistics.median(warm)
    adam = statistics.median(res.adamw_ms[1:])
    flops, how = model_flops(res.cfg, 2, 2048)
    rate = flops / (med / 1e3)
    print(f"[D] losses {[round(x, 4) for x in res.losses]}, grad norms "
          f"{[round(x, 4) for x in res.grad_norms]}")
    print(f"[D] warm step (steps 2-6, CUDA events): median {med:.3f} ms, range "
          f"{min(warm):.3f}-{max(warm):.3f} ms; {res.tokens_per_step / (med / 1e3):.1f} tokens/s "
          f"| card: {card}")
    print(f"[D] model FLOP/s {rate / 1e12:.1f} TFLOP/s = {100 * rate / bf16_peak:.1f} % of "
          f"{bf16_peak / 1e12:.0f} TFLOP/s bf16 ({how} per step); AdamW {adam:.3f} ms = "
          f"{100 * adam / med:.1f} % of the step; peak memory "
          f"{res.peak_bytes / 1e9:.2f} GB | card: {card}")
    out = dict(layers=layers, step_ms=res.step_ms, median_ms=med, adamw_ms=adam,
               tokens_s=res.tokens_per_step / (med / 1e3), tflops=rate / 1e12,
               peak_gb=res.peak_bytes / 1e9, losses=res.losses)
    del res
    free()
    return out


def phase_d_checkpoint(torch, dev):
    """D.3: save at step 2 (AsyncCheckpointer), restore onto the card bit for
    bit, resume to step 4 against an uninterrupted run."""
    import numpy as np
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    with tempfile.TemporaryDirectory(dir=SRC.parent) as tmp:
        first = train.run(TRAIN_SMALL + ["--steps", "2", "--ckpt-dir", tmp,
                                         "--ckpt-every", "2", "--analyze-every", "2"])
        saved = steps.state_tree(first.state)
        fresh = steps.init_state(first.cfg, adamw.AdamWConfig(), seed=1, device=dev)
        tree, manifest = ckpt.restore(tmp, {"state": steps.state_tree(fresh)})
        steps.load_state_tree(fresh, tree["state"])
        back = steps.state_tree(fresh)

        def leaves(t, pre=""):
            for k, v in t.items():
                yield from (leaves(v, f"{pre}{k}/") if isinstance(v, dict) else [(pre + k, v)])

        a, b = dict(leaves(saved)), dict(leaves(back))
        diff = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
        if set(a) != set(b) or diff or manifest["step"] != 2:
            raise RuntimeError(f"restored arrays differ from the saved ones: {diff[:5]}")
        resumed = train.run(TRAIN_SMALL + ["--steps", "4", "--ckpt-dir", tmp,
                                           "--analyze-every", "2", "--resume"])
    whole = train.run(TRAIN_SMALL + ["--steps", "4", "--analyze-every", "2"])
    gaps = [abs(x - y) / abs(y) for x, y in zip(resumed.losses, whole.losses[2:])]
    print(f"[D] checkpoint: {len(a)} arrays ({manifest['total_bytes'] / 1e6:.1f} MB) restored "
          f"onto the card bit for bit; resumed losses {resumed.losses} vs uninterrupted "
          f"{whole.losses[2:]}: relative gaps {[f'{g:.1e}' for g in gaps]} (tolerance "
          f"{RESUME_RTOL})")
    if resumed.start_step != 2 or len(gaps) != 2 or max(gaps) > RESUME_RTOL:
        raise RuntimeError("the resumed run does not continue the uninterrupted one")
    return max(gaps)


@contextlib.contextmanager
def timed_writes(ckpt):
    """The seconds of each checkpoint write (``ckpt.save``, which the
    trainer's ``AsyncCheckpointer`` calls on its worker thread), appended to
    the list yielded."""
    writes, real_save = [], ckpt.save

    def save(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_save(*args, **kwargs)
        finally:
            writes.append(time.perf_counter() - t0)

    ckpt.save = save
    try:
        yield writes
    finally:
        ckpt.save = real_save


def phase_d_bf16_checkpoint(torch, dev, card):
    """D.4: mixtral-8x7b (published widths x1 layer, bf16 parameters, fp32
    master and moments) saves at step 2, restores onto the card bit for bit
    and resumes to step 4 against an uninterrupted run."""
    import shutil
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.device import synchronize
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    args = train.parse_args(D4_ARGV)
    cfg = train.build_config(args)
    need = 2 * cfg.total_params() * D4_CKPT_BYTES + D4_DISK_MARGIN
    free_bytes = shutil.disk_usage(SRC.parent).free
    print(f"[D] D.4 disk: {free_bytes / 1e9:.1f} GB free under {SRC.parent}; two checkpoints "
          f"of ~{cfg.total_params() * D4_CKPT_BYTES / 1e9:.1f} GB and a margin need "
          f"{need / 1e9:.1f} GB")
    if free_bytes < need:
        raise RuntimeError(f"D.4 needs {need / 1e9:.1f} GB of disk for its checkpoints, "
                           f"{free_bytes / 1e9:.1f} GB are free under {SRC.parent}")

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def tensors(state):
        out = {f"params/{k}": v for k, v in state["params"].named_parameters()}
        for group in ("m", "v", "master"):
            out.update({f"opt/{group}/{k}": v for k, v in state["opt"][group].items()})
        out["opt/step"] = state["opt"]["step"]
        return out

    with timed_writes(ckpt) as writes, tempfile.TemporaryDirectory(dir=SRC.parent) as tmp:
        first = train.run(D4_ARGV + ["--steps", "2", "--ckpt-dir", tmp, "--ckpt-every", "2"])
        saved = tensors(first.state)
        n_params = sum(p.numel() for p in first.state["params"].parameters())
        dtypes = sorted({str(t.dtype) for t in saved.values()})
        first_ms, first_peak = first.step_ms, first.peak_bytes
        fresh = steps.init_state(first.cfg, adamw.AdamWConfig(), seed=1, device=dev)
        synchronize(dev)
        t0 = time.perf_counter()
        tree, manifest = ckpt.restore(tmp, {"state": steps.state_tree(fresh)})
        steps.load_state_tree(fresh, tree["state"])
        synchronize(dev)
        restore_s = time.perf_counter() - t0
        groups = [tree["state"]["params"]] + [tree["state"]["opt"][g] for g in ("m", "v", "master")]
        v2 = sum(a.dtype.kind == "V" for g in groups for a in g.values())
        back = tensors(fresh)
        diff = [k for k in saved if saved[k].dtype != back[k].dtype
                or back[k].device != saved[k].device or not torch.equal(bits(saved[k]), bits(back[k]))]
        if set(saved) != set(back) or diff or manifest["step"] != 2:
            raise RuntimeError(f"D.4: restored tensors differ from the saved ones: {diff[:5]}")
        del first, fresh, saved, back, tree, groups
        free()
        resumed = train.run(D4_ARGV + ["--steps", "4", "--ckpt-dir", tmp, "--resume"])
        on_disk = sorted(p.name for p in Path(tmp).glob("step_*"))
        resumed_state = tensors(resumed.state)
        resumed_losses, start = resumed.losses, resumed.start_step
        del resumed
        free()
        whole = train.run(D4_ARGV + ["--steps", "4"])
        whole_state = tensors(whole.state)
        same = sum(torch.equal(bits(resumed_state[k]), bits(whole_state[k])) for k in whole_state)
        n_tensors = len(whole_state)
        del resumed_state, whole_state
    gaps = [abs(x - y) / abs(y) for x, y in zip(resumed_losses, whole.losses[2:])]
    gb = manifest["total_bytes"] / 1e9
    peak = max(first_peak, whole.peak_bytes) / 1e9
    print(f"[D] D.4 {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layer), {args.batch} x "
          f"{args.seq}, {n_params / 1e9:.3f} B parameters (tensors {dtypes}): checkpoint "
          f"{manifest['n_arrays']} arrays ({v2} bf16 as V2), {gb:.2f} GB; restore {restore_s:.1f} s "
          f"({gb / restore_s:.2f} GB/s) onto the card bit for bit; the trainer's writes (step 2, "
          f"step 2 again at the run's end, step 4) {', '.join(f'{w:.1f}' for w in writes)} s "
          f"({gb / min(writes):.2f} GB/s at best; host clock); on disk after the resume: "
          f"{on_disk} | card: {card}")
    print(f"[D] D.4 resumed losses {resumed_losses} vs uninterrupted {whole.losses[2:]}: "
          f"relative gaps {[f'{g:.1e}' for g in gaps]} (tolerance {RESUME_RTOL}); final "
          f"states equal bit for bit in {same} of {n_tensors} tensors")
    warm = whole.step_ms[1:]
    print(f"[D] D.4 warm step (steps 2-4, CUDA events): median {statistics.median(warm):.3f} ms, "
          f"range {min(warm):.3f}-{max(warm):.3f} ms (first run: {[round(x, 3) for x in first_ms]}); "
          f"peak memory {peak:.2f} GB | card: {card}")
    if start != 2 or len(gaps) != 2 or max(gaps) > RESUME_RTOL:
        raise RuntimeError("D.4: the resumed run does not continue the uninterrupted one")
    out = dict(params_b=n_params / 1e9, n_arrays=manifest["n_arrays"], gb=gb, write_s=writes,
               restore_s=restore_s, gaps=gaps, step_ms=whole.step_ms, peak_gb=peak)
    del whole
    free()
    return out


def phase_g_case_studies(card):
    """G.1: the paper's ST and NPAR1WAY case studies through the port, first
    on the fixed taus (the paper's verdicts required), then each counterpart
    of ``examples/*_case_study.py`` once with its own calibration at scale
    1.0.  numpy on the host CPU: the workloads have no device."""
    from repro_torch.launch import npar1way_case_study, st_case_study
    from repro_torch.perfdbg.workloads.npar1way import NPAR1WAYWorkload, run_npar1way
    from repro_torch.perfdbg.workloads.st import STWorkload, run_st

    def cost(rec):
        return rec.measurements().wall_time.sum(axis=1).max()

    st = {name: run_st(STWorkload(scale=G_SCALE, taus=ST_TAUS, **kw)) for name, kw in (
        ("original", {}), ("balanced", dict(balance_region11=True)),
        ("locality+buffered I/O", dict(optimize_locality=True, buffer_io=True)))}
    rep, rep_b, rep_l = (st[k][1] for k in st)
    verdict = (rep.external.clustering.clusters == ST_KINDS and rep.external.cccrs == (11,)
               and set(rep.internal.cccrs) == {8, 11}
               and rep.external_root_causes.core.cores == (("instructions",),)
               and rep.internal_root_causes.core.cores == (("disk_io", "l2_miss_rate"),)
               and not rep_b.external.exists and rep_b.external.severity < 0.15
               and 8 not in rep_l.internal.cccrs and 11 in rep_l.internal.cccrs)
    print(f"[G] ST at scale {G_SCALE}, taus {ST_TAUS}: kinds {rep.external.clustering.clusters}, "
          f"CCCR ext {rep.external.cccrs} int {tuple(sorted(rep.internal.cccrs))}, cores "
          f"{rep.external_root_causes.core.cores} / {rep.internal_root_causes.core.cores}; "
          f"balanced S {rep_b.external.severity:.4f}, locality+buffered int CCCRs "
          f"{tuple(sorted(rep_l.internal.cccrs))}")
    for name, (rec, _, t) in st.items():
        print(f"[G] ST {name}: program time {t * 1e3:.3f} ms (host clock, slowest rank), "
              f"recorded cost {cost(rec):.4f} s | card: {card}")
    if not verdict:
        raise RuntimeError("ST on the fixed taus does not give the paper's verdicts")

    npar = {name: run_npar1way(NPAR1WAYWorkload(scale=G_SCALE, taus=NPAR_TAUS, **kw))
            for name, kw in (("original", {}), ("optimized", dict(eliminate_redundancy=True)))}
    (rec, rep, _), (rec_o, _, _) = npar["original"], npar["optimized"]
    print(f"[G] NPAR1WAY at scale {G_SCALE}: {rep.external.clustering.n_clusters} cluster(s), "
          f"external {rep.external.exists}, int CCCRs {tuple(sorted(rep.internal.cccrs))}, core "
          f"{rep.internal_root_causes.core.cores}; optimized cost {cost(rec_o):.4f} s vs "
          f"{cost(rec):.4f} s")
    for name, (_, _, t) in npar.items():
        print(f"[G] NPAR1WAY {name}: program time {t * 1e3:.3f} ms (host clock, slowest rank) "
              f"| card: {card}")
    if not (rep.external.clustering.n_clusters == 1 and not rep.external.exists
            and set(rep.internal.cccrs) == {3, 12}
            and rep.internal_root_causes.core.cores == (("instructions", "network_io"),)
            and cost(rec_o) < 0.97 * cost(rec)):
        raise RuntimeError("NPAR1WAY on the fixed taus does not give the paper's verdicts")

    out = {}
    for name, module in (("st", st_case_study), ("npar1way", npar1way_case_study)):
        t0 = time.perf_counter()
        if module.main() != 0:
            raise RuntimeError(f"{name} case study failed")
        out[name] = time.perf_counter() - t0
        print(f"[G] {name} case study at scale 1.0, own calibration: {out[name]:.1f} s "
              f"(host clock, every variant) | card: {card}")
    return out


def phase_g_train(torch, dev, counters, card, layers):
    """G.2: the trainer on D.2's command line with the chaos harness and the
    learned diagnosis, then a reduced-width run with ``--pod-gather``.  The
    launch counts, set to 0 before G.1, must still read 0 after the first
    run (and after G.3, in ``main``)."""
    from repro_torch.launch import train

    res = train.run(TRAIN_ARGV + ["--layers", str(layers)] + G_CHAOS)
    launches = {name: fn.launches for name, fn in counters.items()}
    windows = res.report.windows
    print(f"[G] yi-34b full width x{layers} layers, {' '.join(G_CHAOS)}: kernel launches "
          f"since G began {launches}; windows " + "; ".join(
              f"{w.title()}: " + (f"FAILED ({w.error})" if w.failed else
                                  f"gap ranks {list(w.gap_ranks)}, diag {w.diagnosis.kind}")
              for w in windows))
    print(res.health.render())
    bad = [x for x in res.losses + res.grad_norms if not math.isfinite(x)]
    if any(launches.values()) or bad or len(res.losses) != 9:
        raise RuntimeError(f"launches {launches}, losses {res.losses}")
    if len(windows) != 3 or [w.failed for w in windows] != [False, True, False]:
        raise RuntimeError("expected 3 windows with the forced analyzer fault at window 1")
    if "injected analyzer fault at window 1" not in windows[1].error:
        raise RuntimeError(f"window 1 failed otherwise: {windows[1].error}")
    if not {4, 5, 6, 7} <= set(windows[2].gap_ranks) or res.health.corrupt[1] < 1:
        raise RuntimeError("host 1's truncated blob was not quarantined at window 2")
    if any(w.diagnosis is None or w.diagnosis.strategy != "learned"
           for w in windows if not w.failed):
        raise RuntimeError("the windows were not diagnosed by the learned strategy")
    warm = res.step_ms[1:]
    med = statistics.median(warm)
    print(f"[G] chaos + learned run: warm step (steps 2-9, CUDA events) median {med:.3f} ms, "
          f"range {min(warm):.3f}-{max(warm):.3f} ms; losses "
          f"{[round(x, 4) for x in res.losses]}; peak memory {res.peak_bytes / 1e9:.2f} GB "
          f"| card: {card}")
    out = dict(layers=layers, step_ms=res.step_ms, median_ms=med)
    del res
    free()

    pod = train.run(G_POD)
    n = len(pod.report.windows)
    print(f"[G] reduced yi-34b with --pod-gather: {n} window(s), failed "
          f"{sum(w.failed for w in pod.report.windows)}; {pod.health.render().splitlines()[-1].strip()}")
    if n != 2 or any(w.failed for w in pod.report.windows) or pod.health.ok[0] != 2:
        raise RuntimeError("--pod-gather did not deliver every window")
    return out


def gather_worker(rank, world, init, out):
    """G.3, one gloo process: gather seeded windows with the port's
    collector and write this process's shard blobs, the merged snapshots
    and the gather times next to ``out``."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import RegionTree
    from repro_torch.launch.collect import SnapshotCollector
    from repro_torch.perfdbg import RegionRecorder

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        tree = RegionTree("pod")
        for name in ("load", "compute", "allreduce"):
            tree.add(name)
        rng = np.random.default_rng(100 + rank)
        rec = RegionRecorder(tree, 2)
        col = SnapshotCollector(strict=False)
        times = []
        for w in range(G_GATHER_WINDOWS):
            for r in range(2):
                for rid in tree.ids():
                    t = float(rng.uniform(0.5, 2.0))
                    rec.add(r, rid, cpu_time=t, wall_time=t, cycles=2e9 * t,
                            instructions=1e9 * (1 + rank))
                rec.add_program_wall(r, 3.0 + rank)
            snap = rec.reset_window(f"w{w}")
            t0 = time.perf_counter()
            merged = col.gather(snap, total_ranks=2 * world)
            times.append(time.perf_counter() - t0)
            Path(f"{out}.blob{rank}.w{w}").write_bytes(
                snap.to_bytes(rank_offset=2 * rank, checksum=True))
            Path(f"{out}.merged{rank}.w{w}").write_bytes(merged.to_bytes())
        Path(f"{out}.times{rank}").write_text(json.dumps(times))
    finally:
        dist.destroy_process_group()


def phase_g_transport(torch, card):
    """G.3: two gloo processes on the card's host gather seeded windows, and
    the merged snapshot's bytes equal ``merge_blobs`` of both blobs in one
    process; then one NCCL group of world size 1 on the card moves a blob
    through ``SnapshotCollector._allgather`` on the device."""
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.collect import SnapshotCollector, merge_blobs

    with tempfile.TemporaryDirectory(dir=SRC.parent) as tmp:
        init, out = f"{tmp}/init", f"{tmp}/out"
        t0 = time.perf_counter()
        mp.spawn(gather_worker, args=(2, init, out), nprocs=2, join=True)
        wall = time.perf_counter() - t0
        blobs = []
        for w in range(G_GATHER_WINDOWS):
            pair = [Path(f"{out}.blob{r}.w{w}").read_bytes() for r in range(2)]
            want = merge_blobs(pair, total_ranks=4, strict=False).to_bytes()
            got = [Path(f"{out}.merged{r}.w{w}").read_bytes() for r in range(2)]
            if got != [want, want]:
                raise RuntimeError(f"gloo gather of window {w} differs from merge_blobs")
            blobs += pair
        times = [json.loads(Path(f"{out}.times{r}").read_text()) for r in range(2)]
    warm = [t for ts in times for t in ts[1:]]
    print(f"[G] gloo, 2 processes on the card's host: {G_GATHER_WINDOWS} windows gathered, "
          f"merged bytes equal merge_blobs of both blobs; gather ms per window (host clock) "
          f"first {max(ts[0] for ts in times) * 1e3:.3f}, then median "
          f"{statistics.median(warm) * 1e3:.3f}; spawn to join {wall:.1f} s | card: {card}")

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        col = SnapshotCollector()
        got = col._allgather(blobs[0])
        empty = col._allgather(b"")
        t0 = time.perf_counter()
        for b in blobs:
            col._allgather(b)
        nccl_ms = (time.perf_counter() - t0) / len(blobs) * 1e3
    finally:
        dist.destroy_process_group()
    if got != [blobs[0]] or empty != [None]:
        raise RuntimeError("the NCCL all-gather did not return the blob")
    print(f"[G] nccl, world size 1 on the card: _allgather returned the {len(blobs[0])}-byte "
          f"blob and an empty payload as None; {nccl_ms:.3f} ms per call (host clock, "
          f"sizes and payload, {len(blobs)} calls) | card: {card}")
    return dict(gloo_ms=statistics.median(warm) * 1e3, nccl_ms=nccl_ms)


def phase_h_train(torch, counters, card, d_run):
    """H.1: the trainer on D.2's command line under ``--schema tpu`` (so
    ``--costs hlo``): the step's costs counted once on the meta device
    before the first step; the counted matmul flops against the closed form
    plus remat, the warm step against D.2's, the recorded attributes
    against the provider's.  H.2: the count of one step of the full yi-34b
    at the reference's train_4k shape, on the meta device only."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw
    from repro_torch.perfdbg.attributes import RIDGE_INTENSITY

    layers = d_run["layers"]
    res = train.run(TRAIN_ARGV + ["--layers", str(layers)] + H_ARGV)
    launches = {name: fn.launches for name, fn in counters.items()}
    t0 = time.perf_counter()
    counted = steps.count_train_step(res.cfg, adamw.AdamWConfig(), 2, 2048)
    count_s = time.perf_counter() - t0
    st = counted.stats()
    mf, how = model_flops(res.cfg, 2, 2048)
    rf, rhow = remat_flops(res.cfg, 2, 2048)
    mm = counted.matmul_total()
    gap = abs(mm - (mf + rf)) / (mf + rf)
    warm = res.step_ms[1:]
    med = statistics.median(warm)
    step_gap = abs(med - d_run["median_ms"]) / d_run["median_ms"]
    print(f"[H] yi-34b full width x{layers} layers, {' '.join(H_ARGV)}: kernel launches "
          f"{launches}; provider step costs " + " ".join(
              f"{k}={v:.4e}" for k, v in sorted(res.step_costs.items())))
    print(f"[H] the count (meta device, host clock): {count_s:.2f} s; flops {st.flops:.4e}, "
          f"of which matmul {mm:.4e}; closed form {mf:.4e} ({how}) + remat {rf:.4e} ({rhow}) "
          f"= {mf + rf:.4e}: gap {100 * gap:.3f} % (bound {100 * H_FLOPS_RTOL:.0f} %); HBM "
          f"bytes {st.bytes:.4e}, collective bytes {st.total_collective_bytes:.4e}")
    print(f"[H] warm step (steps 2-6, CUDA events): median {med:.3f} ms, range "
          f"{min(warm):.3f}-{max(warm):.3f} ms; D.2 {d_run['median_ms']:.3f} ms: "
          f"{100 * (med / d_run['median_ms'] - 1):+.2f} % (bound {100 * H_STEP_RTOL:.0f} %) "
          f"| card: {card}")
    print("[H] recorded step attributes (last window): " + " ".join(
        f"{k}={v:.4e}" for k, v in sorted(res.step_attrs.items())))
    if any(launches.values()):
        raise RuntimeError(f"H.1 launched kernels: {launches}")
    if res.step_costs["hlo_flops"] != st.flops or res.step_costs["hbm_bytes"] != st.bytes:
        raise RuntimeError("the trainer's provider does not carry the counted step")
    if gap > H_FLOPS_RTOL:
        raise RuntimeError(f"counted matmul flops {mm:.4e} are {100 * gap:.2f} % from the "
                           f"closed form {mf + rf:.4e}")
    if step_gap > H_STEP_RTOL:
        raise RuntimeError(f"H.1's step {med:.3f} ms is {100 * step_gap:.1f} % from D.2's")
    window_steps = int(TRAIN_ARGV[TRAIN_ARGV.index("--analyze-every") + 1])
    attrs = res.step_attrs
    if not (math.isclose(attrs["hlo_flops"], window_steps * st.flops, rel_tol=1e-6)
            and math.isclose(attrs["hbm_boundedness"], res.step_costs["hbm_boundedness"],
                             rel_tol=1e-6)
            and attrs["collective_bytes"] == 0.0):
        raise RuntimeError(f"the recorded attributes are not the provider's: {attrs}")
    del res
    free()

    cfg = get_config("yi-34b")
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = steps.count_train_step(cfg, adamw.AdamWConfig(), H2_BATCH, H2_SEQ,
                                  microbatches=H2_MICROBATCHES)
    full_s = time.perf_counter() - t0
    fst = full.stats()
    intensity = fst.flops / fst.bytes
    print(f"[H] full yi-34b ({cfg.n_layers} layers) one train step at {H2_BATCH} x {H2_SEQ}, "
          f"{H2_MICROBATCHES} microbatches, counted on the meta device in {full_s:.1f} s (host "
          f"clock): flops {fst.flops:.4e} (matmul {full.matmul_total():.4e}), HBM bytes "
          f"{fst.bytes:.4e}, intensity {intensity:.1f} flop/byte against the H100 ridge "
          f"{RIDGE_INTENSITY:.1f} ({'compute' if intensity > RIDGE_INTENSITY else 'memory'} "
          f"side); device memory allocated {torch.cuda.memory_allocated() - before} B | "
          f"card: {card}")
    if torch.cuda.memory_allocated() != before:
        raise RuntimeError("the meta count allocated device memory")
    return dict(count_s=count_s, matmul=mm, closed_form=mf + rf, gap=gap, step_ms=med,
                full_flops=fst.flops, full_bytes=fst.bytes, full_s=full_s,
                full_matmul=full.matmul_total(),
                full_attention=full.matmul_by_op.get("aten.bmm", 0.0))


def phase_h_mesh(torch, card):
    """H.3: a host mesh over an NCCL world of one on the card and one
    ``constrain`` of a CUDA DTensor inside ``sharding_context``; a
    production (2, 16, 16) mesh over a fake world of 512 with one resolved
    placement's local shape."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import runtime
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sharding import resolve_spec, spec_placements

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh()
        x = torch.randn(YI_BATCH, YI_PROMPT, H, DH, device="cuda", dtype=torch.bfloat16)
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        axes = ("batch", None, "heads")
        with runtime.sharding_context(mesh):
            y, ms = timed(lambda: runtime.constrain(dx, *axes))
        want = spec_placements(resolve_spec(x.shape, axes, mesh), mesh)
        same = torch.equal(y.full_tensor(), x)
        print(f"[H] nccl world of 1: host mesh {mesh_lib.mesh_axis_sizes(mesh)} on "
              f"{mesh.device_type}; constrain{axes} of a {tuple(x.shape)} bf16 DTensor gave "
              f"{tuple(y.placements)} (resolve_spec: {want}) in {ms:.3f} ms (CUDA events), "
              f"values {'unchanged' if same else 'CHANGED'} | card: {card}")
        if tuple(y.placements) != want or not same:
            raise RuntimeError("constrain did not give the resolved placements")
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        pod = mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
        shape, axes = (7168, 20480), ("embed", "mlp")      # yi-34b's MLP in-projection
        spec = resolve_spec(shape, axes, pod)
        placements = spec_placements(spec, pod)
        local = distribute_tensor(torch.empty(shape, device="meta"), pod,
                                  placements).to_local().shape
        print(f"[H] fake world of 512: production mesh {mesh_lib.mesh_axis_sizes(pod)}; "
              f"{axes} {shape} -> spec {spec}, placements {placements}, local {tuple(local)} "
              f"(torch {torch.__version__})")
        if spec != ("data", "model") or tuple(local) != (7168 // 16, 20480 // 16):
            raise RuntimeError("the production mesh's placement is not the resolved one")
    finally:
        dist.destroy_process_group()


def banded_prefill_flops(cfg, batch, seq, mesh):
    """(matmul flops per device of one prefill of a MoE arch with a sliding
    window on a (data, model) mesh, as the dry-run counts them, in words):
    batch rows split over ``data``; the projections, heads and experts over
    ``model``; per layer the Q/K/V/O projections, the experts' capacity
    slots (three products each), the router whole, and QK^T and PV of each
    q-chunk of 512 over its band of ``window + 512`` keys (``mha``'s KV
    band), plus the last position's logits."""
    from repro_torch.models.moe import capacity
    data, model = mesh
    d, H, K, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    rows = batch // data
    tokens = rows * seq
    band = min(cfg.window + 512, seq)
    proj = 2 * tokens * d * (2 * H * dh + 2 * K * dh) / model
    experts = 3 * 2 * rows * cfg.n_experts * capacity(cfg, seq) * d * f / model
    router = 2 * tokens * d * cfg.n_experts
    attention = 2 * 2 * rows * (H // model) * seq * band * dh
    logits = 2 * rows * d * cfg.vocab_size / model
    L = cfg.n_layers
    total = L * (proj + experts + router + attention) + logits
    return total, (f"L x (projections {proj:.4e} + experts {experts:.4e} + router {router:.4e} "
                   f"+ attention over the band of {band} keys {attention:.4e}) + logits "
                   f"{logits:.4e} = {total:.4e}; all {seq} keys would add "
                   f"{L * attention * (seq / band - 1):.4e}")


def phase_i(card, h_run):
    """I: the dry-run's cells as processes side by side, the roofline over
    their records, and the checks of the module docstring."""
    import os
    import shutil
    from repro_torch.configs import SHAPES, cell_status, get_config

    out = SRC.parent / "dryrun_out" / "smoke"
    shutil.rmtree(out, ignore_errors=True)
    (out / "dryrun").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    width = max(1, min(len(I_CELLS), os.cpu_count() or 1))
    t0 = time.perf_counter()
    pending, running, logs = list(I_CELLS), [], []
    try:
        while pending or running:
            while pending and len(running) < width:
                cell = pending.pop(0)
                logs.append(open(out / ("__".join(cell) + ".log"), "w"))
                running.append((cell, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
                     "--shape", cell[1], "--mesh", cell[2], "--out", str(out / "dryrun")],
                    env=env, cwd=SRC.parent, stdout=logs[-1], stderr=subprocess.STDOUT)))
            if time.perf_counter() - t0 > I_TIMEOUT:
                raise RuntimeError(f"phase I's dry-runs took over {I_TIMEOUT} s: "
                                   f"{[c for c, _ in running] + pending} unfinished")
            time.sleep(0.5)
            for item in [r for r in running if r[1].poll() is not None]:
                running.remove(item)
                if item[1].returncode:
                    log = (out / ("__".join(item[0]) + ".log")).read_text()
                    raise RuntimeError(f"dry-run {item[0]} exited {item[1].returncode}: "
                                       f"{log[-2000:]}")
    finally:
        for _, proc in running:
            proc.kill()
            proc.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    recs = {cell: json.loads((out / "dryrun" / f"{'__'.join(cell)}.json").read_text())
            for cell in I_CELLS}
    for (arch, shape, mesh), rec in recs.items():
        reason = cell_status(get_config(arch), SHAPES[shape])
        if rec.get("skipped") != reason or not rec.get("ok"):
            raise RuntimeError(f"dry-run {arch} {shape} {mesh}: ok={rec.get('ok')}, skipped="
                               f"{rec.get('skipped')!r} (registry: {reason!r}), error="
                               f"{rec.get('error')}")
    roof = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
                           str(out / "dryrun"), "--out", str(out / "roofline.json")],
                          env=env, cwd=SRC.parent, capture_output=True, text=True,
                          check=True, timeout=120)
    print(roof.stdout.strip())
    rows = {(r["arch"], r["shape"], r["mesh"]): r
            for r in json.loads((out / "roofline.json").read_text()) if not r.get("skipped")}
    counted = [cell for cell, rec in recs.items() if not rec.get("skipped")]
    printed = [line for line in roof.stdout.splitlines()
               if line.startswith("| ") and not line.startswith("| arch")]
    if sorted(rows) != sorted(counted) or len(printed) != len(counted):
        raise RuntimeError(f"the roofline has rows {sorted(rows)} and prints {len(printed)}; "
                           f"the counted cells are {sorted(counted)}")
    for cell in I_CELLS:
        rec = recs[cell]
        if rec.get("skipped"):
            print(f"[I] {' '.join(cell)}: skipped, {rec['skipped']}")
            continue
        r, c = rows[cell], rec["cost"]
        coll = ", ".join(f"{k} {v:.4e}" for k, v in rec["collectives"]["bytes"].items() if v)
        print(f"[I] {' '.join(cell)} (mesh {rec['mesh_shape']}): counted in {rec['count_s']} s "
              f"(host clock, meta device); per device: flops {c['flops']:.4e} (matmul "
              f"{c['matmul flops']:.4e}), HBM bytes {c['bytes accessed']:.4e}, collective "
              f"bytes {coll}, argument bytes {rec['memory']['argument_size_in_bytes']:.4e}; "
              f"terms: compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
              f"collective {r['collective_s']:.4f} s: {r['dominant']} | card: {card}")
    single = recs[("yi-34b", "train_4k", "single")]["cost"]["matmul flops"]
    multi = recs[("yi-34b", "train_4k", "multi")]["cost"]["matmul flops"]
    cfg = get_config("yi-34b")
    # the padded heads add their share of the attention products (the
    # unsharded step's batched products; every other product is 2-d)
    pad = h_run["full_attention"] * (cfg.pad_heads - cfg.n_heads) / cfg.n_heads
    want = h_run["full_matmul"] + pad
    print(f"[I] yi-34b train_4k matmul flops per device: two pods {multi:.4e} / one pod "
          f"{single:.4e} = {multi / single:.4f} (want 0.5 within {100 * I_RTOL:.0f} %); one "
          f"pod x 256 = {256 * single:.4e} against H.2's unsharded {h_run['full_matmul']:.4e} "
          f"+ padded heads {pad:.4e} = {want:.4e}: {256 * single / want:.4f}; phase I's "
          f"processes ran {wall:.1f} s, {width} at a time")
    if abs(multi / single - 0.5) > 0.5 * I_RTOL:
        raise RuntimeError(f"two pods' matmul flops per device are {multi / single:.4f} of one's")
    if abs(256 * single / want - 1) > I_RTOL:
        raise RuntimeError(f"one pod's matmul flops x 256 are {256 * single / want:.4f} of "
                           "the unsharded count plus the padded heads")
    # mixtral's prefill_32k scores each q-chunk's KV band of 4096 + 512 keys
    mx = recs[("mixtral-8x7b", "prefill_32k", "single")]
    shape = SHAPES["prefill_32k"]
    band, how = banded_prefill_flops(get_config("mixtral-8x7b"), shape.global_batch,
                                     shape.seq_len, mx["mesh_shape"])
    got = mx["cost"]["matmul flops"]
    print(f"[I] mixtral-8x7b prefill_32k matmul flops per device {got:.4e} against the banded "
          f"closed form {how}: {got / band:.4f} (want 1 within {100 * I_RTOL:.0f} %)")
    if abs(got / band - 1) > I_RTOL:
        raise RuntimeError(f"mixtral prefill_32k counts {got / band:.4f} of the banded closed form")
    return dict(wall=wall, recs=recs, rows=rows)


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
    from repro_torch.kernels import ssm_state_update as k4
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
    peak_name, (bf16_peak, fp32_peak, bw_peak) = peaks(device_kind)
    phase_a_attention(torch, ops, fa)
    k3_err = phase_a_wkv6(torch, ops, k3)
    k2_err = phase_a_rglru(torch, ops, k2)
    rec_k4 = phase_a_ssm_state_update(torch, ops, k4, (fp32_peak, bw_peak), card)
    print(f"[A] passed in {time.perf_counter() - t_start:.1f} s since start")

    # -- B: the serving paths ------------------------------------------------------
    counters = {"flash_attention": fa.flash_attention, "rglru_scan": k2.rglru_scan_kernel,
                "wkv6": k3.wkv6_kernel, "ssm_state_update": k4.ssm_state_update_kernel}
    steps = 1 + ROUNDS * TOKENS          # the prefill and every decode step
    bf16 = dict(param_dtype="bfloat16")
    yi = dataclasses.replace(get_config("yi-34b"), n_layers=YI_LAYERS, **bf16)
    rwkv = dataclasses.replace(get_config("rwkv6-3b"), **bf16)
    rg = dataclasses.replace(get_config("recurrentgemma-9b"), **bf16)
    nh = nemotron_h_cut(get_config("nemotron-h-47b"))
    runs = {
        yi.name: serve_model(torch, yi, YI_BATCH, YI_PROMPT, counters, {
            "flash_attention": YI_LAYERS, "rglru_scan": 0, "wkv6": 0, "ssm_state_update": 0}),
        rwkv.name: serve_model(torch, rwkv, RWKV_BATCH, RWKV_PROMPT, counters, {
            "flash_attention": 0, "rglru_scan": 0,
            "wkv6": rwkv.layer_kinds.count("rwkv") * steps, "ssm_state_update": 0}),
        rg.name: serve_model(torch, rg, RG_BATCH, RG_PROMPT, counters, {
            "flash_attention": rg.layer_kinds.count("local"),
            "rglru_scan": rg.layer_kinds.count("rec") * steps, "wkv6": 0,
            "ssm_state_update": 0}),
        nh.name: serve_nemotron_h(torch, nh, counters),
    }
    print(f"[B] passed in {time.perf_counter() - t_start:.1f} s since start")

    # -- C: timings at the serving shapes (K4's in phase A) ----------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {}

    # K1 at the serving prefill shapes, each checked against its plain
    # version on the timed inputs: yi-34b's; recurrentgemma-9b's (d_head
    # 256, G 16, window 2048); gemma2-27b's global and local layers (softcap
    # 50, query scale 144^-0.5, G 2) and mixtral-8x7b's (G 4, window 4096)
    # at their served prompt of 8192, where the window excludes pairs and
    # the models' q-chunked plain form stands in for the plain version (its
    # fp32 scores at once would take ~17 GB)
    from repro_torch.models.layers import mha
    rates = (peak_name, bf16_peak, bw_peak)
    rec["flash_attention"] = time_k1(torch, fa, (YI_BATCH, YI_PROMPT, H, KH, DH),
                                     dict(causal=True), ops.attention_ref, sdpa_causal(torch),
                                     rates, card, seed=7)
    for key, shape, kw, plain, library, seed in (
            ("at_dh256", (RG_BATCH, RG_PROMPT, RG_H, RG_KH, RG_DH),
             dict(causal=True, window=RG_WINDOW), ops.attention_ref,
             sdpa_band(torch, RG_WINDOW), 8),
            ("at_gemma2_global", (E_BATCH, E_PROMPT, G2_H, G2_KH, DH), G2_KW, mha,
             flex_softcap(torch, G2_SOFTCAP, G2_SCALE), 13),
            ("at_gemma2_local", (E_BATCH, E_PROMPT, G2_H, G2_KH, DH),
             dict(G2_KW, window=E_WINDOW), mha,
             flex_softcap(torch, G2_SOFTCAP, G2_SCALE, E_WINDOW), 14),
            ("at_mixtral", (E_BATCH, E_PROMPT, MX_H, MX_KH, DH),
             dict(causal=True, window=E_WINDOW), mha, sdpa_band(torch, E_WINDOW), 15)):
        rec["flash_attention"][key] = time_k1(torch, fa, shape, kw, plain, library, rates,
                                              card, seed=seed)
    # whisper-large-v3's three K1 shapes at d_head 64 (phase F's prefill):
    # the encoder (1500 frames on 1500), the cross-attention (224 queries on
    # 1500 frames) and the decoder's causal self-attention
    wh = (WH_BATCH, WH_FRAMES, WH_H, WH_H, WH_DH)
    for key, shape, sk, kw, library, seed in (
            ("at_whisper_encoder", wh, None, dict(causal=False), sdpa_full(torch), 16),
            ("at_whisper_cross", (WH_BATCH, WH_PROMPT, WH_H, WH_H, WH_DH), WH_FRAMES,
             dict(causal=False), sdpa_full(torch), 17),
            ("at_whisper_self", (WH_BATCH, WH_PROMPT, WH_H, WH_H, WH_DH), None,
             dict(causal=True), sdpa_causal(torch), 18)):
        rec["flash_attention"][key] = time_k1(torch, fa, shape, kw, ops.attention_ref,
                                              library, rates, card, seed=seed, Sk=sk)
    # the four models phase E serves at 2 x 2048: causal, no window, softcap
    # or query scale
    for seed, arch in enumerate(C_SMALL_ARCHS, start=19):
        c = get_config(arch)
        shape = (C_SMALL_BATCH, C_SMALL_PROMPT, c.n_heads, c.n_kv_heads, c.d_head)
        rec["flash_attention"][f"at_{arch}"] = time_k1(
            torch, fa, shape, dict(causal=True), ops.attention_ref, sdpa_causal(torch),
            rates, card, seed=seed)

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

    # -- D: training (no kernel on this path) -------------------------------------------
    free()
    phase_d_card_vs_cpu(torch, dev)
    d_run = phase_d_full_width(torch, dev, counters, card, bf16_peak)
    phase_d_checkpoint(torch, dev)
    phase_d_bf16_checkpoint(torch, dev, card)
    print(f"[D] passed; smoke ran {time.perf_counter() - t_start:.1f} s after the card check")

    # -- E: this slice's families through the serving path ------------------------------
    free()
    e_runs = phase_e(torch, counters)
    for name, r in e_runs.items():
        print(f"[E] serving {name} ({r['layers']} layers, {r['params_b']:.2f} B parameters, "
              f"{r['weight_gb']:.2f} GB bf16): prefill {r['prefill_ms']:.3f} ms (first call, "
              f"host clock), warm prefill {r['warm_ms']:.3f} ms with the kernels, "
              f"{r['plain_ms']:.3f} ms with the plain forms (CUDA events); decode "
              f"{r['tok_s']:.1f} tok/s; peak memory {r['peak_gb']:.1f} GB | card: {card}")
    runs.update(e_runs)
    print(f"[E] passed; smoke ran {time.perf_counter() - t_start:.1f} s after the card check")

    # -- F: whisper-large-v3, the encoder-decoder, through the serving path -------------
    free()
    f_runs = phase_f(torch, counters)
    for name, r in f_runs.items():
        print(f"[F] serving {name} ({r['layers']} decoder layers, {r['params_b']:.2f} B "
              f"parameters, {r['weight_gb']:.2f} GB bf16), batch {WH_BATCH}, prompt "
              f"{WH_PROMPT}, {WH_FRAMES} frames: cold prefill {r['prefill_ms']:.3f} ms (first "
              f"call, host clock), warm prefill {r['warm_ms']:.3f} ms with the kernels, "
              f"{r['plain_ms']:.3f} ms with the plain forms (CUDA events); decode "
              f"{r['tok_s']:.1f} tok/s; peak memory {r['peak_gb']:.2f} GB | card: {card}")
    runs.update(f_runs)
    print(f"[F] passed; smoke ran {time.perf_counter() - t_start:.1f} s after the card check")

    # -- G: the case studies, the chaos harness, the learned diagnosis, transport -------
    free()
    for fn in counters.values():
        fn.launches = 0
    phase_g_case_studies(card)
    phase_g_train(torch, dev, counters, card, d_run["layers"])
    phase_g_transport(torch, card)
    g_launches = {name: fn.launches for name, fn in counters.items()}
    if any(g_launches.values()):
        raise RuntimeError(f"phase G launched kernels: {g_launches}")
    print(f"[G] passed, kernel launches {g_launches}; smoke ran "
          f"{time.perf_counter() - t_start:.1f} s after the card check")

    # -- H: measured step costs, mesh, sharding and runtime (no kernel) -----------------
    free()
    for fn in counters.values():
        fn.launches = 0
    h_run = phase_h_train(torch, counters, card, d_run)
    phase_h_mesh(torch, card)
    h_launches = {name: fn.launches for name, fn in counters.items()}
    if any(h_launches.values()):
        raise RuntimeError(f"phase H launched kernels: {h_launches}")
    print(f"[H] passed, kernel launches {h_launches}; smoke ran "
          f"{time.perf_counter() - t_start:.1f} s after the card check")

    # -- I: the multi-pod dry-run and the roofline (no kernel) ---------------------------
    free()
    for fn in counters.values():
        fn.launches = 0
    phase_i(card, h_run)
    i_launches = {name: fn.launches for name, fn in counters.items()}
    if any(i_launches.values()):
        raise RuntimeError(f"phase I launched kernels: {i_launches}")
    print(f"[I] passed, kernel launches {i_launches}; smoke ran "
          f"{time.perf_counter() - t_start:.1f} s after the card check")

    def launches(name):
        return sum(r["launches"][name] for r in runs.values())

    by_path = lambda name: {m: r["launches"][name] for m, r in runs.items()}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention_sm90.cu",
             simt_source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:35",
             launches=launches("flash_attention"), launches_by_path=by_path("flash_attention"),
             launches_by_variant={kind: sum(r["k1_by_variant"][kind] for r in runs.values())
                                  for kind in fa.ENTRIES},
             **rec["flash_attention"]),
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
        dict(name="ssm_state_update", route="cuda",
             source="src/repro_torch/csrc/ssm_state_update.cu", replaces=None,
             launches=launches("ssm_state_update"),
             launches_by_path=by_path("ssm_state_update"), **rec_k4),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
