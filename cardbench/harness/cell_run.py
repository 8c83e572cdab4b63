"""One run of one cell: set-up, warm-up, the measured window, the check.

The window opens at the start of the first batch after the warm-up.
Batches start back to back (a closed loop of one client holding ``batch``
requests) for ``seconds``; the window closes when the last batch started
in that time has finished, so it holds whole batches only and every rate
is taken over all of their work and all of the window's time (a window
cut inside a batch would count a burst of its tokens or not, by where the
cut falls).  The traced run (``trace``) profiles the same window.
"""
from __future__ import annotations

import gc
import time
import torch

from . import judge, manifest
from .peaks import bound, peaks
from .program import Server
from .trace import Tracer, busy_and_gaps, clip, device_ops, idle_by_span, top

WARM_DECODE_STEPS = 4


def record_of(server: Server, batches, t0: float, t1: float, seconds: float,
              setup_s: float, kernels) -> dict:
    """What every metric reader reads (``metrics/<name>.py``)."""
    cfg, tr, mk = server.cfg, server.traffic, server.marks
    fam = manifest.family(cfg["family"])
    B, S = tr["batch"], tr["prompt_len"]
    kind = torch.cuda.get_device_name(server.device) if server.device.type == "cuda" else "cpu"
    rec = dict(cfg=cfg, traffic=tr, t0=t0, t1=t1, seconds=seconds, setup_s=setup_s,
               batch_size=B, batches=[], lags_ms=[])
    for b in batches:
        rec["batches"].append(dict(
            t_start=b.t_start, t_tok=list(b.t_tok),
            prefill_ms=mk.elapsed_ms(*b.prefill_marks),
            decode_ms=[mk.elapsed_ms(a, c) for a, c in b.decode_marks],
            prefill_flops=fam.prefill_flops(cfg, B, S),
            decode_flops=[fam.decode_flops(cfg, B, S + i) for i in range(len(b.decode_marks))]))
        done = server.analyzed.get(str(b.index))
        if done is not None:
            rec["lags_ms"].append((done - b.t_submit) * 1e3)
    if kernels is not None:
        busy, gaps = busy_and_gaps(clip(kernels, t0, t1), t0, t1)
        rec.update(busy_s=busy, window_s=t1 - t0,
                   kernels=[k for k in kernels if t0 <= k[1] < t1],
                   idle_by_span=idle_by_span(gaps, server.spans))
        _, (bf16, _, bw) = peaks(kind)
        rec["k1_bound_ms"] = bound(*fam.k1_work(cfg, B, S), bf16, bw)[0]
    if kind != "cpu":
        rec["bf16_peak"] = peaks(kind)[1][0]
    return rec


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, t_proc0: float,
        device: torch.device, control: bool = False) -> dict:
    cfg, tr = cell.config, cell.traffic
    server = Server(cfg, tr, seed, device)
    server.serve_batch(-1, decode_steps=min(tr["output_tokens"] - 1, WARM_DECODE_STEPS))
    server.pipe.drain()
    tracer = Tracer() if trace else None
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_proc0
    batches = []
    while time.perf_counter() < t0 + seconds:
        batches.append(server.serve_batch(len(batches)))
    t1 = batches[-1].t_end
    server.close()
    kernels = None
    if tracer is not None:
        tracer.stop()
        kernels = tracer.kernels()
    rec = record_of(server, batches, t0, t1, t1 - t0, setup_s, kernels)
    failed = sum(1 for b in batches if str(b.index) not in server.analyzed)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    server.model = None
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result = judge.check(cfg, tr, seed, batches, device, control=control)
    readers = manifest.readers(cell.per_layer if trace else cell.end_to_end)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for name, read in readers.items():
        value = read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": units.get(name, "")}
    out = dict(attempted=len(batches) * tr["batch"], failed=failed * tr["batch"],
               metrics=metrics, peak=peak, check=result, record=rec)
    if kernels is not None:
        out["breakdown"] = {"device_ops": top(device_ops(rec["kernels"])),
                            "idle_gaps": top(rec["idle_by_span"])}
    return out
