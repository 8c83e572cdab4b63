"""The system under test, driven the way the port serves: the port's
``Model`` built on the benchmark's weights, and the closed serving loop
the measured window runs.

One batch at a time: ``Model.prefill`` with the kernels on
(``transformer.KERNELS``, as ``launch/serve.py`` serves), then one
``Model.decode_step`` per further output token, each next token the greedy
argmax.  Every token is copied to pinned host memory as it is produced and
its arrival timed on the host clock once the copy has landed; the copy of
step i is awaited after step i + 1 is launched, so the device is never held
back for it.  Each batch runs in ``perfdbg.Instrumenter`` regions
``prefill``, ``decode`` and ``detokenize`` over a one-rank
``RegionRecorder``, and its window goes to the port's
``AsyncAnalysisSession`` through ``submit_recorder``, as ``serve()`` does.
CUDA events bracket every prefill and decode-step call, and host spans
every call into a layer (for the traced run's idle gaps).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from . import weights as W
from .manifest import family


def build_model(cfg: dict, seed: int, device: torch.device):
    """The port's ``Model`` with every parameter, by name, one of the
    benchmark's drawn tensors (no copy)."""
    from repro_torch.models import Model
    fam = family(cfg["family"])
    model = Model(fam.port_config(cfg), "meta")
    expected = dict(model.named_parameters())
    for group in fam.group_names(cfg):
        for name, t in W.draw_group(cfg, seed, group, device).items():
            meta = expected.pop(name, None)
            if meta is None or meta.shape != t.shape or meta.dtype != t.dtype:
                raise ValueError(f"the port's Model has no parameter {name} "
                                 f"{tuple(t.shape)} {t.dtype} (it has {meta})")
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr, nn.Parameter(t, requires_grad=False))
    if expected:
        raise ValueError(f"parameters the benchmark does not draw: {sorted(expected)}")
    return model


class Marks:
    """Device-order marks: CUDA events on the card, host clock on the CPU
    (the tests' rehearsal)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclasses.dataclass
class Batch:
    index: int
    t_start: float
    t_tok: List[float]              # host arrival of each output token
    tokens: np.ndarray              # (batch, output_tokens) served ids
    prefill_marks: tuple
    decode_marks: List[tuple]
    t_submit: float = 0.0
    t_end: float = 0.0              # its window submitted: the next may start


class Server:
    """The served model and its instrumentation for one run."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core import AsyncAnalysisSession, RegionTree
        from repro_torch.perfdbg import Instrumenter, RegionRecorder
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.model = build_model(cfg, seed, device)
        self.pcfg = self.model.cfg
        B, N = traffic["batch"], traffic["output_tokens"] - 1
        self.s_buf = traffic["prompt_len"] + N
        self.marks = Marks(device)
        self.host = torch.empty((N + 1, B), dtype=torch.long,
                                pin_memory=device.type == "cuda")
        self.tree = RegionTree("serve")
        for nm in ("prefill", "decode", "detokenize"):
            self.tree.add(nm)
        self.rec = RegionRecorder(self.tree, 1, schema="paper")
        self.ins = Instrumenter(self.rec, 0)
        self.lock = threading.Lock()
        self.analyzed: Dict[str, float] = {}     # label -> host time of on_window
        self.spans: List[tuple] = []             # (name, t0 ns, t1 ns)
        self.pipe = AsyncAnalysisSession(self.tree, max_queue=4, supervised=True,
                                         escalate_after=1 << 30,
                                         on_window=self._on_window)

    def _on_window(self, entry) -> None:
        with self.lock:
            self.analyzed[entry.label] = time.perf_counter()

    def _span(self, name: str, t0: int) -> int:
        t1 = time.perf_counter_ns()
        self.spans.append((name, t0, t1))
        return t1

    def serve_batch(self, index: int, decode_steps: Optional[int] = None) -> Batch:
        """Serve the ``index``-th batch of the traffic (the warm-up: -1) and
        submit its window; ``decode_steps`` cuts the decode loop short
        (the warm-up only)."""
        cfg, tr, model, mk = self.pcfg, self.traffic, self.model, self.marks
        B, S = tr["batch"], tr["prompt_len"]
        N = tr["output_tokens"] - 1 if decode_steps is None else decode_steps
        host, ins = self.host, self.ins
        t_start = time.perf_counter()
        t = time.perf_counter_ns()
        prompts = W.prompts(self.cfg, tr, self.seed, index, self.device)
        t = self._span("serve.prompts", t)
        t_tok = [0.0] * (N + 1)
        decode_marks = []
        with ins.program():
            with ins.region("prefill", instructions=2 * cfg.active_params() * B * S):
                m0 = mk.mark()
                logits, cache = model.prefill(prompts, self.s_buf)
                m1 = mk.mark()
                t = self._span("serve.prefill", t)
                tok = logits[:, -1:].argmax(-1)
                host[0].copy_(tok[:, 0], non_blocking=True)
                mk.wait(mk.mark())
                t_tok[0] = time.perf_counter()
                t = self._span("serve.sample", t)
            with ins.region("decode", instructions=2 * cfg.active_params() * B * N):
                pending = None
                for i in range(N):
                    d0 = mk.mark()
                    logits, cache = model.decode_step(tok, S + i, cache)
                    d1 = mk.mark()
                    decode_marks.append((d0, d1))
                    t = self._span("serve.decode_step", t)
                    tok = logits.argmax(-1)
                    host[i + 1].copy_(tok[:, 0], non_blocking=True)
                    arrived = mk.mark()
                    if pending is not None:
                        mk.wait(pending)
                        t_tok[i] = time.perf_counter()
                    pending = arrived
                    t = self._span("serve.sample", t)
                if pending is not None:
                    mk.wait(pending)
                    t_tok[N] = time.perf_counter()
                    t = self._span("serve.sample", t)
            with ins.region("detokenize", nominal_cpi=1.0, disk_io=4.0 * B * N):
                tokens = host[:N + 1].numpy().T.copy()
                t = self._span("serve.detokenize", t)
        del logits, cache
        batch = Batch(index, t_start, t_tok, tokens, (m0, m1), decode_marks)
        batch.t_submit = time.perf_counter()
        self.pipe.submit_recorder(self.rec, label=str(index))
        self._span("analysis.submit", t)
        batch.t_end = time.perf_counter()
        return batch

    def close(self, timeout: float = 120.0) -> None:
        self.pipe.close(timeout=timeout)
