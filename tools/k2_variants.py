#!/usr/bin/env python3
"""What K2's staged kernel is held back by: build variants of
``csrc/rglru_scan.cu`` and time each at recurrentgemma-9b's prefill shape on
the card, beside ``torch.add`` over the same bytes.

    python3 tools/k2_variants.py

Needs one CUDA card (sm_90a) and ``nvcc``.  Each variant is the kernel's
source with a piece of its text replaced, built by ``nvcc`` into a scratch
directory and called through the same C entry point
(``rglru_scan_staged_launch``); every variant but "no h stores" must equal
the kernel's h bit for bit, or the script fails.  Variants:

  kernel              the source as it is (64-channel CTAs, TMA loads of
                      32-step blocks of a and b into a 3-stage ring, every
                      lane storing h at every step);
  TW=.. TS=.. NS=..   the kernel with another tile width, block length and
                      ring depth (SHAPES; TW=32 TS=64 NS=4 is the first
                      version of the design);
  cp.async loads      the producer warp's 32 lanes copy a and b in 16-byte
                      chunks by cp.async (zero-filled past S and W) and arrive
                      on the stage's mbarrier by cp.async.mbarrier.arrive,
                      instead of one lane issuing two TMA boxes;
  TMA store of h      the consumers write each block of h into a double
                      buffer in shared memory, and one thread stores it by
                      TMA;
  streaming stores    h stored with st.global.cs (evict first);
  L2 promotion 256B   the tensor maps' L2 promotion (kernel: 128B);
  no h stores         the recurrence runs but h is never stored (a timing of
                      the read path, not a result).

``torch.add(a, b, out=h)`` reads and writes the same bytes as the scan (two
(B, S, W) fp32 reads, one write): the card's rate for this mix, as a
yardstick.  Prints one line per variant and round (rounds alternate the
order), each with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, S, W = 2, 4096, 4096        # recurrentgemma-9b's prefill shape (rnn_width 4096)

PRODUCER = """    if (lane == 0) {
      for (int blk = 0; blk < nb; ++blk) {
        const int s = blk % NS;
        if (blk >= NS) mbar_wait(empty(s), (blk / NS - 1) & 1);
        mbar_expect_tx(full(s), 2 * BLOCK_BYTES);
        tma_load(smem_u32(ring.a[s]), &ta, w0, blk * TS, bi, full(s));
        tma_load(smem_u32(ring.b[s]), &tb, w0, blk * TS, bi, full(s));
      }
    }
    return;
"""
CP_ASYNC = (
    ("    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,\n",
     "    const float* __restrict__ a, const float* __restrict__ b,\n"),
    ("      mbar_init(full(s), 1);      // the producer's expect_tx; TMA completes the bytes\n",
     "      mbar_init(full(s), 32);     // every producer lane's cp.async arrival\n"),
    (PRODUCER, """    for (int blk = 0; blk < nb; ++blk) {
      const int s = blk % NS;
      if (blk >= NS) mbar_wait(empty(s), (blk / NS - 1) & 1);
#pragma unroll 4
      for (int c = lane; c < TS * TW / 4; c += 32) {
        const int i = c / (TW / 4), j = (c % (TW / 4)) * 4;
        const int t = blk * TS + i, w = w0 + j;
        const bool in = t < S && w < W;
        const long long off = in ? ((long long)bi * S + t) * W + w : 0;
        const int n = in ? 16 : 0;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(&ring.a[s][i][j])),
                     "l"(a + off), "r"(n) : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(&ring.b[s][i][j])),
                     "l"(b + off), "r"(n) : "memory");
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(full(s)) : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
"""),
    ("      ta, tb, static_cast<const float*>(h0), static_cast<float*>(h), S, W);\n",
     "      static_cast<const float*>(a), static_cast<const float*>(b),\n"
     "      static_cast<const float*>(h0), static_cast<float*>(h), S, W);\n"),
)

CONSUMER_LOOP = """  float* hp = h + (long long)bi * S * W + w;
  for (int blk = 0; blk < nb; ++blk) {
    const int s = blk % NS;
    mbar_wait(full(s), (blk / NS) & 1);
    const float(*as)[TW] = ring.a[s];
    const float(*bs)[TW] = ring.b[s];
    float* hb = hp + (long long)blk * TS * W;
    const int n = min(TS, S - blk * TS);
    if (n == TS) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        hv = step(as[i][c], hv, bs[i][c]);
        if (live) hb[(long long)i * W] = hv;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        hv = step(as[i][c], hv, bs[i][c]);
        if (live) hb[(long long)i * W] = hv;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // the warp is done with stage s
  }
"""
TMA_STORE = (
    ("  float b[NS][TS][TW];\n", "  float b[NS][TS][TW];\n  float h[2][TS][TW];\n"),
    ("    const float* __restrict__ h0, float* __restrict__ h, int S, int W) {\n",
     "    const __grid_constant__ CUtensorMap th, const float* __restrict__ h0, int S, int W) {\n"),
    (CONSUMER_LOOP, """  for (int blk = 0; blk < nb; ++blk) {
    const int s = blk % NS;
    mbar_wait(full(s), (blk / NS) & 1);
    const float(*as)[TW] = ring.a[s];
    const float(*bs)[TW] = ring.b[s];
    float(*hs)[TW] = ring.h[blk & 1];
    if (blk >= 2 && threadIdx.x == 0)   // the store of block blk - 2 has read this buffer
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(32 * NCW) : "memory");
    const int n = min(TS, S - blk * TS);
    if (n == TS) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        hv = step(as[i][c], hv, bs[i][c]);
        hs[i][c] = hv;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        hv = step(as[i][c], hv, bs[i][c]);
        hs[i][c] = hv;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // visible to TMA
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    asm volatile("bar.sync 1, %0;" ::"n"(32 * NCW) : "memory");
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
                   ::"l"(reinterpret_cast<uint64_t>(&th)), "r"(smem_u32(hs)), "r"(w0),
                   "r"(blk * TS), "r"(bi) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  (void)live;
"""),
    ("      ta, tb, static_cast<const float*>(h0), static_cast<float*>(h), S, W);\n",
     "      ta, tb, th, static_cast<const float*>(h0), S, W);\n"),
    ("  if ((err = prepare_staged()) != cudaSuccess) return (int)err;\n  rglru_scan_staged<<<",
     "  if ((err = prepare_staged()) != cudaSuccess) return (int)err;\n  CUtensorMap th;\n"
     "  if ((err = encode(&th, h, B, S, W)) != cudaSuccess) return (int)err;\n"
     "  rglru_scan_staged<<<"),
)

# (channels per CTA, steps per block, stages): the kernel's TW, TS and NS
SHAPES = [(32, 64, 4), (64, 64, 4), (32, 32, 3), (32, 16, 4), (64, 16, 4), (64, 32, 4),
          (64, 64, 3), (128, 32, 3), (128, 32, 4), (128, 16, 4)]


def shape(src: str, tw: int, ts: int, ns: int) -> str:
    for name, val in (("TW", tw), ("TS", ts), ("NS", ns)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};", src)
        if n != 1:
            raise RuntimeError(f"csrc/rglru_scan.cu no longer sets {name} once")
    return src


PROMOTE_256 = (("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"),)
STREAMING = (("if (live) hb[(long long)i * W] = hv;", "if (live) __stcs(&hb[(long long)i * W], hv);"),)
NO_STORES = (("if (live) hb[(long long)i * W] = hv;", "if (hv == 1234.5f) hb[(long long)i * W] = hv;"),)


def replace(src: str, pieces) -> str:
    for old, new in pieces:
        if old not in src:
            raise RuntimeError(f"csrc/rglru_scan.cu no longer holds {old[:70]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    return {
        "kernel": src,
        **{f"TW={tw} TS={ts} NS={ns}": shape(src, tw, ts, ns) for tw, ts, ns in SHAPES},
        "cp.async loads": replace(src, CP_ASYNC),
        "TMA store of h": replace(src, TMA_STORE),
        "streaming stores": replace(src, STREAMING),
        "L2 promotion 256B": replace(src, PROMOTE_256),
        "no h stores": replace(src, NO_STORES),
    }


def build(sources: dict, out: Path) -> dict:
    from repro_torch.kernels import _build
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu, lib = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = [l.strip() for l in log.splitlines() if "registers" in l]
        print(f"[k2 variants] build {name:18s} ptxas (staged, simple): {regs}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import rglru_scan as k2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    src = (ROOT / "src" / "repro_torch" / "csrc" / "rglru_scan.cu").read_text()
    g = torch.Generator(device="cuda").manual_seed(10)
    a = 0.2 + 0.79 * torch.rand((B, S, W), generator=g, device="cuda")
    b = torch.randn((B, S, W), generator=g, device="cuda")
    h = torch.empty_like(a)
    nbytes = 3 * a.numel() * 4

    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for name, lib in build(variants(src), Path(tmp)).items():
            fn = ctypes.CDLL(str(lib)).rglru_scan_staged_launch
            fn.argtypes, fn.restype = k2.ARGTYPES, ctypes.c_int
            fns[name] = fn

        def call(fn):
            err = fn(a.data_ptr(), b.data_ptr(), None, h.data_ptr(), B, S, W,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rglru_scan_staged_launch failed: cudaError_t {err}")

        call(fns["kernel"])
        want = h.clone()
        for name, fn in fns.items():
            h.zero_()
            call(fn)
            torch.cuda.synchronize()
            if name != "no h stores" and not torch.equal(h, want):
                raise RuntimeError(f"variant {name!r} differs from the kernel")

        def ms(fn, iters=20):
            for _ in range(3):
                fn()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        runs = {name: (lambda fn=fn: call(fn)) for name, fn in fns.items()}
        runs["torch.add (same bytes)"] = lambda: torch.add(a, b, out=h)
        names = list(runs)
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                t = ms(runs[name])
                print(f"[k2 variants] round {rnd} {name:24s} {t:.4f} ms "
                      f"({nbytes / t / 1e9:.3f} TB/s) at B={B} S={S} W={W} fp32 | card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
