"""Sharding context and cost scopes of the port.

Counterpart of ``repro/runtime.py``.  Model code is mesh-agnostic; a
caller activates a (mesh, rules) context, and ``constrain(x,
*logical_axes)`` then redistributes a ``DTensor`` to the placements its
logical axes resolve to on that mesh (``repro_torch.launch.sharding``), as
the reference's ``with_sharding_constraint`` pins a traced array.  Outside
a context (unit tests, single-device runs), and for a plain tensor inside
one, it returns its argument unchanged.

``scope(name)`` names the part of a step that the code under it belongs
to (``embed``, ``layers.<i>``, ``final_norm``, ``loss``, ``optimizer``);
the model and optimizer enter it, and the step-cost counter
(``repro_torch.launch.hlo_analysis``) reads it with ``current_scope()``
to split a step's costs by part.  It changes no computation.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharding_ctx",
                                                      default=None)
_SCOPE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_cost_scope",
                                                        default=None)


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[dict] = None):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def active() -> bool:
    return _CTX.get() is not None


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Pin ``x``'s placements by logical axis names (None = replicated dim).
    Trailing dims may be omitted (treated as None)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    from repro_torch.launch.sharding import resolve_spec, spec_placements
    axes = tuple(logical_axes) + (None,) * (x.ndim - len(logical_axes))
    spec = resolve_spec(x.shape, axes, mesh, rules)
    return x.redistribute(mesh, spec_placements(spec, mesh))


@contextlib.contextmanager
def scope(name: str):
    """Code under this context (or a function under this decorator)
    belongs to part ``name`` of the step; the innermost scope wins."""
    token = _SCOPE.set(name)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_scope() -> Optional[str]:
    return _SCOPE.get()
