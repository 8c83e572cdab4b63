#!/usr/bin/env python3
"""Where K3's time goes: build variants of ``csrc/wkv6.cu`` with one part of
the work taken out and time each at rwkv6-3b's prefill shape on the card.

    python3 tools/k3_variants.py

Needs one CUDA card (sm_90a) and ``nvcc``.  Each variant is the kernel's
source with a piece of its text replaced, built by ``nvcc`` into a scratch
directory and called through the same C entry point; only "kernel" computes
the right y (the others are timings, not results).  Variants:

  kernel            the source as it is;
  recurrence only   the producer warp copies, widens and sums nothing: the
                    consumers run the recurrence on whatever shared memory
                    holds (the time of the recurrence and the barriers);
  without expf      logw widened as it is instead of through expf;
  without y sums    the producer never sums the partials of y;
  without both      the two above together;
  without waits     no cp.async.wait_group (races: the time of the wait).

Prints one line per variant and round (rounds alternate the order), each
with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, T, H, DH = 4, 2048, 40, 64        # rwkv6-3b's prefill shape

FLUSH = ("      if (blk > 0) flush(blk - 1);\n", "    flush(nb - 1);\n")
PRODUCER_LOOP = ("      if (s < nb) issue(s);\n", "    widen(0);\n",
                 "      if (blk + NR - 1 < nb) issue(blk + NR - 1);\n",
                 "        widen(blk + 1);\n") + FLUSH
EXPF = ("make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w))", "lw")
WAIT = "        cp_async_wait<NR - 2>();    // this lane's copies of blk + 1 landed\n"


def drop(src: str, *pieces: str) -> str:
    for piece in pieces:
        if piece not in src:
            raise RuntimeError(f"csrc/wkv6.cu no longer holds {piece!r}")
        src = src.replace(piece, "")
    return src


def no_expf(src: str) -> str:
    if EXPF[0] not in src:
        raise RuntimeError("csrc/wkv6.cu no longer widens logw through expf")
    return src.replace(*EXPF)


def variants(src: str) -> dict:
    return {
        "kernel": src,
        "recurrence only": drop(src, *PRODUCER_LOOP),
        "without expf": no_expf(src),
        "without y sums": drop(src, *FLUSH),
        "without both": drop(no_expf(src), *FLUSH),
        "without waits": drop(src, WAIT),
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
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import wkv6 as k3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    src = (ROOT / "src" / "repro_torch" / "csrc" / "wkv6.cu").read_text()
    g = torch.Generator(device="cuda").manual_seed(9)
    mk = lambda: 0.5 * torch.randn((B, T, H, DH), generator=g, device="cuda")
    r, k, v = mk().bfloat16(), mk().bfloat16(), mk().bfloat16()
    logw = -torch.exp(torch.clamp(mk(), -3, 0.5))
    u = 0.3 * torch.randn((H, DH), generator=g, device="cuda")
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, DH, DH), device="cuda")
    strides = [st for t in (r, k, v, logw, y) for st in t.stride()[:3]]

    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for name, lib in build(variants(src), Path(tmp)).items():
            fn = ctypes.CDLL(str(lib)).wkv6_fwd_launch
            fn.argtypes, fn.restype = k3.ARGTYPES, ctypes.c_int
            fns[name] = fn

        def call(fn):
            err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                     None, y.data_ptr(), s_out.data_ptr(), 1, B, T, H, DH, *strides,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"wkv6_fwd_launch failed: cudaError_t {err}")

        def ms(fn, iters=20):
            for _ in range(3):
                call(fn)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                call(fn)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        names = list(fns)
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                print(f"[k3 variants] round {rnd} {name:16s} {ms(fns[name]):.4f} ms at "
                      f"B={B} T={T} H={H} dh={DH} bf16 | card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
