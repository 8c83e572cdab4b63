"""Sharding context and cost scopes of the port.

Counterpart of ``repro/runtime.py``.  Model code is mesh-agnostic; a
caller activates a (mesh, rules) context, and ``constrain(x,
*logical_axes)`` then redistributes a ``DTensor`` to the placements its
logical axes resolve to on that mesh (``repro_torch.launch.sharding``), as
the reference's ``with_sharding_constraint`` pins a traced array.  Outside
a context (unit tests, single-device runs), and for a plain tensor inside
one, it returns its argument unchanged.

Inside a context the models also run, on ``DTensor``s, what a sharded
program runs, each device's part computed on its local shards:
``gathered`` (a parameter as a product uses it: its FSDP shards
gathered), ``tp_matmul`` (a linear layer, column- or row-parallel by its
weight's placements), ``tp_lookup`` (the embedding, a partial sum over the
vocabulary's shards), ``block_local`` (a block-diagonal product) and
``on_shards`` (a computation independent across the sharded dimensions:
attention per batch row and head, the WKV6 recurrence, MoE dispatch and
combine, a cache's writes; ``pad`` likewise).  Each is the plain
operation outside a context or on plain tensors.

``unflatten`` and ``flatten`` are the reshapes that split one dimension
into several (heads out of a projection) or merge several into one.  XLA
reshards such a reshape of a sharded array by itself; a ``DTensor``
refuses one whose split dimension is not evenly divisible by its shards,
so inside a context these first redistribute to placements the reshape
keeps (a collective, which a step's count sees, as XLA's reshard is one)
and, for ``unflatten``, then to the placements the new dimensions' logical
axes resolve to.  Outside a context, and for a plain tensor, each is
``reshape``.

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
    resolved = _resolved(x, x.shape, logical_axes)
    if resolved is None:
        return x
    mesh, target = resolved
    return x.redistribute(mesh, target)


def _resolved(x: torch.Tensor, shape, logical_axes):
    """(mesh, placements of ``shape`` by ``logical_axes``) in the active
    context, or None for a plain tensor or outside a context."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return None
    mesh, rules = ctx
    from repro_torch.launch.sharding import resolve_spec, spec_placements
    axes = tuple(logical_axes) + (None,) * (len(shape) - len(logical_axes))
    return mesh, spec_placements(resolve_spec(shape, axes, mesh, rules), mesh)


def gathered(w: torch.Tensor, *logical_axes) -> torch.Tensor:
    """A parameter as a product uses it: inside a context a DTensor
    parameter is redistributed to the placements of its logical axes
    without the FSDP rule (``"embed"`` sharded over nothing), as XLA
    all-gathers an FSDP-sharded weight for its product; the backward of
    that gather reduce-scatters the gradient back onto the parameter's
    shards.  Its tensor-parallel shards stay."""
    ctx = _CTX.get()
    if ctx is None:
        return w
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    from repro_torch.launch.sharding import DEFAULT_RULES, resolve_spec, spec_placements
    used = dict(rules or DEFAULT_RULES, embed=())
    spec = resolve_spec(w.shape, logical_axes, mesh, used)
    return w.redistribute(mesh, spec_placements(spec, mesh))


def tp_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-d (gathered) weight.  Inside a context, with
    DTensors, it is computed as a tensor-parallel program computes it, on
    each device's shards: per mesh axis, where ``w``'s input dimension is
    split, ``x`` is split on its last dimension and the product is a
    partial sum (row-parallel); where ``w``'s output dimension is split,
    ``x`` is replicated and the product split alike (column-parallel);
    where ``x``'s batch rows are split, the product's are.  ``x`` is
    redistributed to that layout first; the gradients come back as the
    same program's (``w``'s a partial sum over the batch shards, reduced
    onto its placements by the train step)."""
    if _CTX.get() is None or not (hasattr(x, "placements") and hasattr(w, "placements")):
        return torch.matmul(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = Shard(x.ndim - 1)
    xp, yp, xg, wg = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(pw, Shard) and pw.dim == 0:       # row-parallel
            xp.append(last), yp.append(Partial()), xg.append(last), wg.append(pw)
        elif isinstance(pw, Shard):                     # column-parallel
            xp.append(Replicate()), yp.append(last), xg.append(Partial()), wg.append(pw)
        elif isinstance(px, Shard) and px.dim == 0:     # batch rows
            xp.append(px), yp.append(px), xg.append(px), wg.append(Partial())
        else:
            xp.append(Replicate()), yp.append(Replicate()), xg.append(Replicate()), \
                wg.append(Replicate())
    x = x.redistribute(x.device_mesh, tuple(xp))
    return local_map(torch.matmul, out_placements=yp, in_grad_placements=(xg, wg))(x, w)


def tp_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a (gathered) table.  Inside a context, with
    DTensors, it is computed as a tensor-parallel program computes it, on
    each device's shards: where the table's rows (the vocabulary) are
    split, each device looks the ids up in its slice, zeros the others',
    and the result is a partial sum over that axis; where the ids' batch
    rows are split, the result's are."""
    if _CTX.get() is None or not (hasattr(table, "placements") and hasattr(ids, "placements")):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    out, ip, tg = [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        if isinstance(pt, Shard) and pt.dim == 0:       # a vocabulary slice
            out.append(Partial()), ip.append(Replicate()), tg.append(pt)
        elif isinstance(pi, Shard) and pi.dim == 0:     # batch rows
            out.append(pi), ip.append(pi), tg.append(Partial())
        else:
            out.append(Replicate()), ip.append(Replicate()), tg.append(pt)
    split = any(isinstance(p, Partial) for p in out)
    first = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)[1][0]

    def lookup(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        if not split:
            return t[i]
        local = i - first
        inside = (local >= 0) & (local < t.shape[0])
        rows = t[torch.where(inside, local, torch.zeros_like(local))]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return local_map(lookup, out_placements=out, in_grad_placements=(tg, ip))(
        table, ids.redistribute(mesh, tuple(ip)))


def pad(x: torch.Tensor, widths) -> torch.Tensor:
    """``F.pad(x, widths)`` (zeros).  Inside a context a DTensor not split
    on a padded dimension is padded shard by shard, which is the same
    padding, without DTensor's sharding propagation."""
    import torch.nn.functional as F
    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    pl = placements(x)
    if pl is not None and any(getattr(p, "dim", None) in padded for p in pl):
        pl = None
    return on_shards(lambda t: F.pad(t, widths), pl)(x)


def block_local(fn, w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``fn(w, b, x)`` for a block-diagonal product: ``w`` (n, blk, blk)
    and ``b`` (n * blk,) map each block of ``blk`` features of ``x``'s last
    dimension to itself.  Inside a context, with DTensors, each device
    computes the blocks it holds: where ``x``'s features are split into
    whole blocks, ``w`` and ``b`` are split by block alike; elsewhere the
    features are gathered; ``x``'s batch rows stay split."""
    if _CTX.get() is None or not all(hasattr(t, "placements") for t in (w, b, x)):
        return fn(w, b, x)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last, n = x.device_mesh, x.ndim - 1, w.shape[0]
    xp, wp, wg = [], [], []
    for size, p in zip(mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == last and n % size == 0:
            xp.append(p), wp.append(Shard(0)), wg.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 0:
            xp.append(p), wp.append(Replicate()), wg.append(Partial())
        else:
            xp.append(Replicate()), wp.append(Replicate()), wg.append(Replicate())
    x = x.redistribute(mesh, tuple(xp))
    w, b = w.redistribute(mesh, tuple(wp)), b.redistribute(mesh, tuple(wp))
    return local_map(fn, out_placements=xp, in_grad_placements=(wg, wg, xp))(w, b, x)


def placements(x: torch.Tensor):
    """A DTensor's placements inside a context, else None."""
    return tuple(x.placements) if _CTX.get() is not None and hasattr(x, "placements") \
        else None


def on_shards(fn, *out_placements, grads=None):
    """``fn`` to run on the local shards of its DTensor arguments, its
    results wrapped as DTensors with ``out_placements`` (one per result),
    when a context is active and every placement is given; ``fn`` itself
    otherwise.  For a computation that is independent across the sharded
    dimensions of its arguments (attention or a recurrence per batch row
    and head), where the caller has placed the arguments alike: it then
    runs as each device runs it, and its ops are counted on the local
    shards without DTensor's sharding propagation.  ``grads``, one entry
    per argument, gives the placements of the arguments' gradients where
    they differ from the arguments' own (a replicated parameter's is a
    partial sum over the batch rows' shards)."""
    if _CTX.get() is None or any(p is None for p in out_placements):
        return fn
    from torch.distributed.tensor.experimental import local_map
    # one result's placements are a list; several results', a tuple of them
    out = [list(p) for p in out_placements]
    return local_map(fn, out_placements=out[0] if len(out) == 1 else tuple(out),
                     in_grad_placements=grads)


def unflatten(x: torch.Tensor, dim: int, sizes, *logical_axes) -> torch.Tensor:
    """``x`` with dimension ``dim`` split into ``sizes``; a DTensor comes
    out placed by ``logical_axes`` (one per dimension of the result, as
    ``constrain`` takes them).  A shard of the first new dimension is a
    shard of ``dim`` before the split; a shard of a later one is cut from
    the replicated dimension after it (no collective)."""
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    resolved = _resolved(x, shape, logical_axes)
    if resolved is None:
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    mesh, target = resolved
    n = len(sizes)

    def before(p):
        if not isinstance(p, Shard) or p.dim < dim:
            return p
        if p.dim == dim:
            return Shard(dim)
        return Replicate() if p.dim < dim + n else Shard(p.dim - n + 1)

    pre = tuple(before(p) for p in target)
    return x.redistribute(mesh, pre).reshape(shape).redistribute(mesh, target)


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x`` with dimensions ``start`` .. ``end`` merged into one; a
    DTensor sharded on a merged dimension but the first is gathered on it
    first (a merged dimension keeps only its major shard), and its
    gradient is brought back to the merged placements before it is split
    again."""
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[end + 1:])
    if _CTX.get() is None:
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    pre = tuple(Replicate() if isinstance(p, Shard) and start < p.dim <= end else p
                for p in x.placements)
    y = x.redistribute(x.device_mesh, pre).reshape(shape)
    # the forward keeps y's placements; the backward brings the gradient
    # back to them, which the reshape's backward can split again
    return y.redistribute(y.device_mesh, y.placements)


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
