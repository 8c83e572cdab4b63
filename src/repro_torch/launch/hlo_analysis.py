"""Trip-aware cost analysis of one step of the port.

Counterpart of ``repro/launch/hlo_analysis.py``, which parses the
compiled per-device HLO of a jitted step.  PyTorch compiles no HLO: this
module runs the step once under a ``TorchDispatchMode`` and counts the
aten operations it dispatches, by the reference's rules:

  flops            2*M*N*K for the matmul family (the formulas
                   ``torch.utils.flop_counter`` registers: mm, addmm, bmm,
                   baddbmm, convolution, ...), 1 per result element for
                   every other op
  hbm bytes        every tensor operand and result of an op, but nothing
                   for ops that move no bytes (views, ``_unsafe_view``,
                   ``detach``, ``alias``, ``empty*``; the counterpart of
                   ``_SKIP_BYTES``).  A slice is a view, so the op that
                   reads it reads its numel, not its storage's (the
                   counterpart of ``_sliced_params``)
  collective bytes per kind (all-reduce / all-gather / reduce-scatter /
                   all-to-all), result-shape proxy, from the
                   ``_c10d_functional`` ops and their in-place ``c10d``
                   forms

Every op the step runs is counted as often as it runs, so loops over
layers, microbatches and loss chunks, and the forward recomputed under
per-layer remat, are counted as XLA's compiled step counts them.  A
tensor subclass (a ``DTensor``) is left to decompose into the ops on its
local shard, which are the ones counted: the costs are per device.

The step runs on whatever its arguments live on; the trainer gives it
copies of its state and batch on the ``meta`` device
(``launch.steps.count_train_step``), so counting needs no device memory,
no device time, and gives the same numbers on the CPU and on the card.

Sub-entries of :meth:`Analyzer.stats_by_computation` are the cost scopes
the model and optimizer enter (``repro_torch.runtime.scope``): ``embed``,
``layers.<i>`` (and ``enc_layers.<i>``), ``final_norm``, ``loss`` (the
chunked cross-entropy), ``optimizer`` (the AdamW update), and ``other``
for what lies outside them (positions, gradient accumulation).  The
forward, and the forward recomputed in the backward, run under their
scope; an op of the backward proper takes the scope of the autograd node
that runs it, which the forward tagged (nodes made inside a composite op
take the scope of the node that consumes them).  The sub-entries are
disjoint and sum to the entry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..runtime import current_scope

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass
class Stats:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Optional[Dict[str, float]] = None
    collective_counts: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.collective_bytes is None:
            self.collective_bytes = {k: 0.0 for k in COLLECTIVE_KINDS}
        if self.collective_counts is None:
            self.collective_counts = {k: 0.0 for k in COLLECTIVE_KINDS}

    def add(self, other: "Stats", mult: float = 1.0) -> None:
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        for k in COLLECTIVE_KINDS:
            self.collective_bytes[k] += mult * other.collective_bytes[k]
            self.collective_counts[k] += mult * other.collective_counts[k]

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes}


# collective op -> (kind, its result is the op's output: True, or its first
# argument, the in-place c10d forms' output buffers: False)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", True),
    "_c10d_functional.all_reduce_": ("all-reduce", True),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", True),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", True),
    "_c10d_functional.all_to_all_single": ("all-to-all", True),
    "c10d.allreduce_": ("all-reduce", False),
    "c10d.allgather_": ("all-gather", False),
    "c10d._allgather_base_": ("all-gather", False),
    "c10d.reduce_scatter_": ("reduce-scatter", False),
    "c10d._reduce_scatter_base_": ("reduce-scatter", False),
    "c10d.alltoall_base_": ("all-to-all", False),
    "c10d.alltoall_": ("all-to-all", False),
}

# ops that move no bytes besides the views (``OpOverload.is_view``)
_NO_BYTES = {"aten._unsafe_view", "aten.empty", "aten.empty_like", "aten.empty_strided",
             "aten.new_empty", "aten.new_empty_strided", "aten.lift_fresh",
             "_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd"}

OTHER = "other"


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _numel(x) -> float:
    return float(sum(t.numel() for t in _tensors(x)))


class Analyzer:
    """Costs of one call of ``fn(*args)``, which runs once, here, under the
    counting mode; the entry is named ``fn.__name__`` and its return value
    is kept as ``result``."""

    def __init__(self, fn: Callable, *args):
        self.entry = fn.__name__
        self.matmul_flops: Dict[str, float] = {}   # scope -> matmul-family flops
        self.matmul_by_op: Dict[str, float] = {}   # op (aten.mm, aten.bmm, ...) -> flops
        self._scopes: Dict[str, Stats] = {}
        with _Tagging(), _Counting(self):
            self.result = fn(*args)
        self._total = Stats()
        for st in self._scopes.values():
            self._total.add(st)

    def stats(self) -> Stats:
        return self._total

    def stats_by_computation(self) -> Dict[str, Stats]:
        """Per-scope aggregates (the top-level modules, the loss, the
        optimizer, ``other``) and the entry, whose value is :meth:`stats`.
        The scopes are disjoint and sum to the entry (unlike the
        reference's computations, a callee's cost is not in its
        caller's), so ``perfdbg.costs.HloCosts`` may attribute any of them."""
        out = {self.entry: self._total}
        out.update(self._scopes)
        return out

    def matmul_total(self) -> float:
        """Flops of the matmul family over the whole call."""
        return sum(self.matmul_flops.values())

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket)
        scope = _scope()
        st = self._scopes.setdefault(scope, Stats())
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, from_out = coll
            st.collective_bytes[kind] += _nbytes(out if from_out else args[0])
            st.collective_counts[kind] += 1
        elif func.overloadpacket in flop_registry:
            f = float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            st.flops += f
            self.matmul_flops[scope] = self.matmul_flops.get(scope, 0.0) + f
            self.matmul_by_op[name] = self.matmul_by_op.get(name, 0.0) + f
        else:
            st.flops += _numel(out)
        if not (func.is_view or name in _NO_BYTES):
            st.bytes += _nbytes(list(args) + list(kwargs.values())) + _nbytes(out)


def _scope() -> str:
    """The current cost scope, else (in the backward) the scope of the
    autograd node that runs, else ``other``."""
    scope = current_scope()
    if scope is not None:
        return scope
    node = torch._C._current_autograd_node()
    if node is None:
        return OTHER
    if "analyzer_walked" not in node.metadata:
        _walk(node, node.metadata.get("analyzer_scope", OTHER))
    return node.metadata["analyzer_scope"]


def _walk(root, scope: str) -> None:
    """Give every node reachable from ``root`` that the forward did not tag
    the scope of the node that consumes its output."""
    stack: List[Tuple[object, str]] = [(root, scope)]
    while stack:
        node, inherited = stack.pop()
        meta = node.metadata
        if "analyzer_walked" in meta:
            continue
        meta["analyzer_walked"] = True
        own = meta.setdefault("analyzer_scope", inherited)
        for nxt, _ in node.next_functions:
            if nxt is not None:
                stack.append((nxt, own))


class _Counting(TorchDispatchMode):
    def __init__(self, analyzer: Analyzer):
        super().__init__()
        self.analyzer = analyzer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)   # a DTensor's sharding propagation
        if any(t not in (torch.Tensor, nn.Parameter) for t in types):
            return NotImplemented          # a subclass decomposes first
        out = func(*args, **kwargs)
        self.analyzer._count(func, args, kwargs, out)
        return out


class _Tagging(TorchFunctionMode):
    """Tags the autograd node of every result of the forward with its
    scope, for the backward to read."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        nodes = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        if nodes:
            scope = _scope()
            for node in nodes:
                node.metadata.setdefault("analyzer_scope", scope)
        return out


def analyze(fn: Callable, *args) -> Dict:
    return Analyzer(fn, *args).stats().as_dict()
