"""Logical-axis -> mesh-axis sharding rules (MaxText-style), for DTensor.

Counterpart of ``repro/launch/sharding.py``, with its rules and its
resolver.  Every parameter/input/cache dimension carries a *logical* axis
name; rules map each name to an ordered list of mesh-axis candidates.
Resolution is greedy per tensor: the first candidate whose mesh size
divides the dimension and whose mesh axes are still unused by this tensor
wins; otherwise the dimension is replicated.  This one mechanism yields
FSDP (embed->data), TP (mlp/heads/vocab->model), pod-level DP
(batch->(pod,data)) and the long-context fallback (cache_seq->data exactly
when batch=1 cannot use it).

A resolved spec is a tuple with one entry per dimension (a mesh axis name,
a tuple of names, or None), trailing Nones trimmed: entry for entry the
reference's ``PartitionSpec``.  ``spec_placements`` turns it into DTensor
placements on a ``DeviceMesh``: ``Shard(d)`` on every mesh dimension that
dimension d names, ``Replicate()`` on the others.  A tuple such as
``("pod", "data")`` shards d over both, in mesh order, so the pod is the
major split, as in JAX.  Trees are the port's nested dicts and lists;
their leaves are tensors (anything with ``shape``) and, in axes trees,
tuples of logical names.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from .mesh import mesh_axis_sizes

Candidate = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[Candidate], ...]

# rules: logical axis -> ordered candidates (each a mesh axis or axis tuple)
DEFAULT_RULES: Dict[str, Tuple[Candidate, ...]] = {
    # inputs / activations
    "batch": (("pod", "data"), "data"),
    "seq": (),
    "cache_seq": ("data",),            # wins only when batch can't shard
    # params
    "embed": ("data",),                # FSDP
    "embed2": (),
    "mlp": ("model",),                 # TP
    "q_proj": ("model",),
    "kv_proj": ("model",),
    "vocab": ("model",),
    "experts": (),                     # TP inside experts via mlp axis
    "experts_ep": ("data",),           # EP: experts sharded over data
    "rnn": ("model",),
    "layers": (),
    # caches
    "kv_heads": ("model",),
    "head_dim": ("model",),            # fallback when kv_heads indivisible
    "heads": ("model",),
    "q_grp": ("model",),               # grouped-query dim of attention scores
}


def _mesh_axes(cand: Candidate) -> Tuple[str, ...]:
    return (cand,) if isinstance(cand, str) else tuple(cand)


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh, rules: Optional[Dict] = None) -> Spec:
    """Spec for one tensor on ``mesh`` (a ``DeviceMesh``, or anything
    ``mesh.mesh_axis_sizes`` reads)."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, logical in zip(shape, axes):
        chosen = None
        if logical is not None:
            for cand in rules.get(logical, ()):
                names = _mesh_axes(cand)
                if not set(names) <= set(sizes):
                    # e.g. 'pod' absent in a single-pod mesh: try its suffix
                    names = tuple(n for n in names if n in sizes)
                    if not names:
                        continue
                    cand = names if len(names) > 1 else names[0]
                size = 1
                for n in _mesh_axes(cand):
                    size *= sizes[n]
                if dim % size == 0 and not (set(_mesh_axes(cand)) & used):
                    chosen = cand
                    used.update(_mesh_axes(cand))
                    break
        parts.append(chosen)
    # trim trailing None for tidier specs
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: per
    mesh dimension, ``Shard(d)`` where tensor dimension d names it, else
    ``Replicate()``; a mesh dimension of size 1 splits nothing and is
    ``Replicate()`` (a DTensor would refuse reshapes of a "split" dimension
    there).  A dimension split over several mesh axes must name them in
    mesh order (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        dims = [names.index(n) for n in _mesh_axes(part)]
        if dims != sorted(dims):
            raise ValueError(f"dimension {d} splits over {part}, which is "
                             f"not in the mesh's order {tuple(names)}")
        for m in dims:
            if mesh.shape[m] > 1:
                out[m] = Shard(d)
    return tuple(out)


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *matching subtrees of rest)`` over the dicts and
    lists of ``tree``, whose leaves have a ``shape``."""
    if hasattr(tree, "shape"):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return [_map(fn, v, *(r[i] for r in rest), path=path + (i,))
            for i, v in enumerate(tree)]


def tree_shardings(shape_tree, axes_tree, mesh, rules: Optional[Dict] = None):
    """Placements tree for (tensors, logical axes) trees: what
    ``distribute_tensor(t, mesh, placements)`` takes for each leaf."""
    return _map(lambda _, t, ax: spec_placements(
        resolve_spec(t.shape, ax, mesh, rules), mesh), shape_tree, axes_tree)


# ---------------------------------------------------------------------------
# Logical axes for non-param trees
# ---------------------------------------------------------------------------

def batch_axes(batch_tree) -> Any:
    """Input batches: first dim is 'batch', rest replicated.  Scalars get ()."""
    def one(_, x):
        nd = len(x.shape)
        if nd == 0:
            return ()
        return ("batch",) + (None,) * (nd - 1)
    return _map(one, batch_tree)


def cache_axes_for(cfg, cache_tree) -> Any:
    """Decode-cache logical axes.  The port's cache is one dict per layer
    (batch, ...), the reference's stacked layout without its leading
    'layers': attention kv get ('batch','cache_seq','kv_heads','head_dim');
    recurrent states shard their width over 'rnn'/'heads'."""
    def one(path, x):
        name = path[-1]
        nd = len(x.shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            return ("batch", "cache_seq", "kv_heads", "head_dim")[:nd]
        if name == "wkv":       # (B, H, dh, dh)
            return ("batch", "heads", None, None)[:nd]
        if name in ("h",):      # (B, rw)
            return ("batch", "rnn")[:nd]
        if name == "conv":      # (B, taps-1, rw)
            return ("batch", None, "rnn")[:nd]
        if name.endswith("shift"):
            return ("batch", "embed")[:nd]
        return ("batch",) + (None,) * (nd - 1)
    return _map(one, cache_tree)


def opt_state_axes(param_axes, has_master: bool = False) -> Dict[str, Any]:
    """Adam moments inherit param logical axes (ZeRO-1); step is replicated;
    the fp32 master copy (mixed precision) mirrors the params."""
    out = {"m": param_axes, "v": param_axes, "step": ()}
    if has_master:
        out["master"] = param_axes
    return out
