"""Faults of the timed path, planted underneath the harness, for the check
that ``correct`` comes out false: each breaks the port's ``Model`` the way
a serving cell can go wrong.  ``planted(name)`` holds one for a block and
puts the port back after it; ``calibrate.py --faults`` reads them at a
cell's own size, the tests at a tiny one."""
from __future__ import annotations

from contextlib import contextmanager

import torch


def state_unchanged(Model) -> None:
    """decode_step leaves the cache as it found it."""
    step0 = Model.decode_step

    def step(self, tokens, pos, cache, *a, **k):
        copy = [{n: t.clone() for n, t in c.items()} for c in cache]
        logits, _ = step0(self, tokens, pos, copy, *a, **k)
        return logits, cache
    Model.decode_step = step


def half_batch(Model) -> None:
    """prefill computes the first half of the batch and hands its results
    to the rest."""
    prefill0 = Model.prefill

    def prefill(self, tokens, s_buf, *a, **k):
        n, h = tokens.shape[0], tokens.shape[0] // 2
        logits, cache = prefill0(self, tokens[:h], s_buf, *a, **k)
        idx = torch.arange(n, device=tokens.device) % h
        return logits[idx], [{k2: t[idx] for k2, t in c.items()} for c in cache]
    Model.prefill = prefill


def token_altered(Model) -> None:
    """every third decode step's logits favour token 7 where they are made."""
    step0 = Model.decode_step
    calls = []

    def step(self, tokens, pos, cache, *a, **k):
        logits, cache = step0(self, tokens, pos, cache, *a, **k)
        calls.append(pos)
        if len(calls) % 3 == 2:
            logits = logits.clone()
            logits[..., 7] += 1e3
        return logits, cache
    Model.decode_step = step


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, token_altered)}


@contextmanager
def planted(name: str):
    from repro_torch.models import Model
    saved = Model.prefill, Model.decode_step
    FAULTS[name](Model)
    try:
        yield
    finally:
        Model.prefill, Model.decode_step = saved
