"""Checkpoints with atomic commits and restart, in the reference's layout.

Counterpart of ``repro/ckpt/checkpoint.py``:

    <dir>/step_<N>/arrays.npz + manifest.json   (atomic via tmp+rename)

``save`` flattens a tree of dicts, lists and tuples by keypath (dict keys
and sequence indices joined with ``/``, as the reference's pytree paths
are) into one ``.npz``; its leaves are tensors, numpy arrays or Python
numbers.  A train state goes through ``launch.steps.state_tree`` first,
which lays parameters and AdamW moments out as the reference's stacked
groups, so a checkpoint written by either package restores in the other.
``restore`` rebuilds a template's structure: tensor leaves come back as
tensors on the template leaf's device, numpy leaves as arrays, Python
numbers as numbers.  ``AsyncCheckpointer`` copies the tree to host memory
synchronously and writes it on a worker thread; a failed background write
is re-raised, never silent.

A bfloat16 tensor is written as its 16-bit patterns viewed as numpy's
``V2``: the reference's ``np.savez`` writes an ml_dtypes ``bfloat16`` leaf
so, and ``np.load`` returns ``V2`` for both packages' files.  ``restore``
turns a ``V2`` array back into a bfloat16 tensor, bit for bit, where the
template leaf is one; a numpy template leaf gets the ``V2`` array as it is,
as in the reference (``launch.steps.load_state_tree`` reads it as
bfloat16).  The port needs no ml_dtypes.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"

#: Manifest keys ``save`` writes itself.  ``extra`` keys must not collide —
#: a driver stashing e.g. pipeline state under ``"step"`` would silently
#: clobber the restore step.
RESERVED_MANIFEST_KEYS = frozenset({"step", "n_arrays", "total_bytes",
                                    "time"})


def _is_bf16_bits(dtype: np.dtype) -> bool:
    """Whether ``dtype`` is the ``V2`` a bfloat16 leaf is saved and loaded
    as (either package's)."""
    return dtype.kind == "V" and dtype.itemsize == 2 and dtype.names is None


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; a bfloat16 tensor's bits as ``V2``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor sharing its memory; a ``V2`` array, or an
    ml_dtypes ``bfloat16`` one (by dtype name), as bfloat16, bit for bit."""
    if _is_bf16_bits(a.dtype) or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array (a copy for tensors)."""
    return to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _items(tree, prefix: str = ""):
    """(keypath, leaf) pairs; empty containers and None have no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host_array(leaf) for key, leaf in _items(tree)}


def _to_host(tree):
    """The tree with every tensor leaf copied to a numpy array."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _host_array(tree)
    return tree


def _unflatten(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    want = tuple(np.shape(template))
    if tuple(arr.shape) != want:
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != {want}")
    if isinstance(template, (int, float)):      # python scalars round-trip
        return type(template)(arr.item())
    if isinstance(template, torch.Tensor):
        if _is_bf16_bits(arr.dtype) and template.dtype != torch.bfloat16:
            raise TypeError(f"{key}: the checkpoint holds bfloat16 bits (V2) for a "
                            f"{template.dtype} tensor")
        return to_tensor(arr).to(template.device)
    return arr


def save(ckpt_dir, step: int, state, extra: Optional[Dict[str, Any]] = None,
         keep: int = 3) -> pathlib.Path:
    if extra:
        clash = RESERVED_MANIFEST_KEYS & set(extra)
        if clash:
            raise ValueError(f"extra manifest keys {sorted(clash)} collide "
                             f"with reserved keys "
                             f"{sorted(RESERVED_MANIFEST_KEYS)}")
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}_{int(time.time()*1e6)}"
    tmp.mkdir()
    flat = _flatten(state)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {"step": step, "n_arrays": len(flat),
                "total_bytes": int(sum(a.nbytes for a in flat.values())),
                "time": time.time(), **(extra or {})}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=2))
    final = ckpt_dir / f"step_{step}"
    # re-saving an existing step: set the old dir aside (rename, cheap) so a
    # valid step_<N> exists at every instant; roll it back if the commit
    # rename fails
    old = None
    if final.exists():
        old = ckpt_dir / f".old_step_{step}_{int(time.time()*1e6)}"
        final.rename(old)
    try:
        tmp.rename(final)                  # atomic commit
    except BaseException:
        if old is not None:
            old.rename(final)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted((int(p.name.split("_")[1]), p)
                   for p in ckpt_dir.glob("step_*") if p.is_dir())
    for _, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
    # leftovers of crashed saves (uncommitted tmps, unswept set-asides):
    # saves to one dir are serialized and the current save's tmp was renamed
    # away before _gc runs, so everything matching these is stale
    for pat in (".tmp_step_*", ".old_step_*"):
        for p in ckpt_dir.glob(pat):
            shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("step_*"):
        if (p / MANIFEST).exists():        # incomplete dirs are invisible
            try:
                json.loads((p / MANIFEST).read_text())
                steps.append(int(p.name.split("_")[1]))
            except Exception:
                continue
    return max(steps) if steps else None


def restore(ckpt_dir, template, step: Optional[int] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint (the latest, unless ``step``) into ``template``'s
    structure; returns (tree, manifest)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"step_{step}"
    manifest = json.loads((path / MANIFEST).read_text())
    with np.load(path / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(template, flat), manifest


class AsyncCheckpointer:
    """Threaded save: snapshot to host memory synchronously, write in the
    background; ``wait()`` joins before the next save or at shutdown.

    A background save that fails is never silent: the worker's exception is
    recorded and re-raised from ``wait()`` (and thus from the next
    ``save()``, which joins first) — ``last_path`` keeps pointing at the
    last checkpoint that actually committed."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self.last_path: Optional[pathlib.Path] = None

    def save(self, step: int, state, extra=None) -> None:
        self.wait()                  # re-raises a failed in-flight save
        host_state = _to_host(state)

        def work():
            try:
                self.last_path = save(self.ckpt_dir, step, host_state, extra,
                                      self.keep)
            except BaseException as e:
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
