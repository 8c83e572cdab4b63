"""Train state and train step of the port.

Counterpart of ``repro/launch/steps.py:56-100`` (``init_state``,
``make_train_step``).  The state is ``{"params": Model, "opt": AdamW
state}``; the step runs forward and chunked loss under autograd, takes the
gradients with ``torch.autograd.grad`` (accumulated in fp32 over
microbatches), and applies the hand-written AdamW in place.
``state_tree`` / ``load_state_tree`` carry the state to and from the
reference's pytree layout (``params/...``, ``opt/m/...``, ``opt/v/...``,
``opt/step``, ``opt/master/...`` by checkpoint keypath), which the
checkpoints of both packages share.  ``count_train_step`` counts one step's
costs on the ``meta`` device (the counterpart of ``compiled_hlo``: no HLO,
the step's dispatched ops, ``launch.hlo_analysis``) and
``hlo_cost_provider`` turns the count into the measured cost provider.
The reference's jit and sharding helpers (``jit_train_step``,
``state_specs``) have no counterpart yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.model import Model, init_params, loss_fn
from ..models.params import from_jax_layout, load_named, to_jax_layout
from ..optim import adamw

State = Dict[str, object]
Batch = Dict[str, torch.Tensor]


def init_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, seed: int = 0,
               device: Union[str, torch.device] = "cuda") -> State:
    """Seeded parameters (``models.init_params``, on the card unless
    ``device`` is ``"cpu"``) and a fresh AdamW state beside them."""
    model = init_params(cfg, seed, device)
    return state_for(model, opt_cfg)


def state_for(model: Model, opt_cfg: adamw.AdamWConfig) -> State:
    """A train state around existing parameters (e.g. carried over from
    the reference by ``from_jax_params``)."""
    return {"params": model,
            "opt": adamw.init(dict(model.named_parameters()), opt_cfg)}


def value_and_grad(model: Model, batch: Batch,
                   remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {parameter name: gradient}) of ``models.model.loss_fn`` on
    ``batch`` ({"tokens", "labels"}, and "patches" or "frames" where the
    model takes them); the parameters are made to take gradients."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    # the vision stub's patch_proj is the one parameter a batch may not
    # reach (no "patches"): it gets zeros, as jax.grad gives it; every
    # other parameter must be reached, or autograd raises (an
    # encoder-decoder's frame_proj is reached by the "frames" it requires)
    unreached = ([n for n in named if n.startswith("patch_proj.")]
                 if batch.get("patches") is None else [])
    wrt = [n for n in named if n not in unreached]
    with torch.enable_grad():
        loss = loss_fn(model, batch, remat=remat)
        grads = dict(zip(wrt, torch.autograd.grad(loss, [named[n] for n in wrt])))
    grads.update((n, torch.zeros_like(named[n])) for n in unreached)
    return loss.detach(), {n: grads[n] for n in named}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1,
                    on_grads: Optional[Callable[[], None]] = None):
    """(state, batch) -> (state, metrics {"loss", "grad_norm", "lr"}: 0-d
    tensors); gradients accumulate in fp32 over ``microbatches`` equal
    splits of the batch.  ``on_grads``, if given, is called between the
    gradients and the optimizer update (a timing mark).  The state is
    updated in place and returned."""

    def train_step(state: State, batch: Batch) -> Tuple[State, Dict[str, torch.Tensor]]:
        model = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(model, batch)
        else:
            splits = {k: v.chunk(microbatches) for k, v in batch.items()}
            if any(len(s) != microbatches or s[0].shape != s[-1].shape
                   for s in splits.values()):
                raise ValueError(f"batch does not split into {microbatches} "
                                 "equal microbatches")
            loss, grads = None, None
            for i in range(microbatches):
                l, g = value_and_grad(model, {k: s[i] for k, s in splits.items()})
                if grads is None:
                    loss, grads = l.float(), {n: t.float() for n, t in g.items()}
                else:
                    loss = loss + l
                    for n, t in g.items():
                        grads[n].add_(t)
            inv = 1.0 / microbatches
            loss = loss * inv
            for t in grads.values():
                t.mul_(inv)
        if on_grads is not None:
            on_grads()
        _, _, metrics = adamw.update(grads, state["opt"],
                                     dict(model.named_parameters()), opt_cfg)
        metrics["loss"] = loss
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Measured costs (the counted half of the cost-provider layer)
# ---------------------------------------------------------------------------

def count_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, batch: int,
                     seq: int, microbatches: int = 1):
    """``hlo_analysis.Analyzer`` of one call of ``make_train_step`` on a
    fresh state and a (batch, seq) token batch on the ``meta`` device:
    nothing is allocated and nothing runs, only shapes propagate, so the
    count costs host time alone and is the same on any host.  The
    counterpart of the reference's ``compiled_hlo``, which lowers and
    compiles the step once more."""
    from .hlo_analysis import Analyzer
    model = Model(cfg, "meta")
    state = state_for(model, opt_cfg)
    tokens = torch.zeros((batch, seq), dtype=torch.long, device="meta")
    step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    return Analyzer(step, state, {"tokens": tokens, "labels": tokens})


def hlo_cost_provider(analyzer, regions, anchor: str = "step", base=None):
    """Build a ``perfdbg.costs.HloCosts`` provider from one counted step:
    its per-scope stats (``analyzer.stats_by_computation()``) anchored at
    ``regions``' ``anchor`` (the region whose body runs the step),
    name-prefix re-attribution to the other regions, analytic ``base``
    fallback for regions the step cannot see (host-side data / checkpoint
    I/O).  This glue lives in the launch layer so ``perfdbg`` never
    imports the counter."""
    from ..perfdbg.costs import HloCosts
    return HloCosts(regions, base=base).add_module(
        analyzer.stats_by_computation(), entry=analyzer.entry, anchor=anchor)


# ---------------------------------------------------------------------------
# The reference's pytree layout (checkpoints)
# ---------------------------------------------------------------------------

def state_tree(state: State) -> Dict[str, object]:
    """The state as the reference's pytree, each group of tensors flattened
    by keypath: ``{"params": {keypath: array}, "opt": {"m": {...}, "v":
    {...}, "step": array, ["master": {...}]}}`` (numpy copies).  A bfloat16
    tensor raises ``NotImplementedError``."""
    model: Model = state["params"]
    opt = state["opt"]
    cfg = model.cfg
    out_opt: Dict[str, object] = {
        "m": to_jax_layout(cfg, opt["m"]), "v": to_jax_layout(cfg, opt["v"]),
        "step": opt["step"].detach().to("cpu", copy=True).numpy()}
    if "master" in opt:
        out_opt["master"] = to_jax_layout(cfg, opt["master"])
    return {"params": to_jax_layout(cfg, model.state_dict()), "opt": out_opt}


@torch.no_grad()
def load_state_tree(state: State, tree: Mapping[str, object]) -> State:
    """Copy a tree of ``state_tree``'s layout (numpy arrays, e.g. restored
    from a checkpoint of either package) into ``state`` in place."""
    model: Model = state["params"]
    opt = state["opt"]
    cfg = model.cfg
    load_named(dict(model.named_parameters()),
               from_jax_layout(cfg, tree["params"]), "the checkpoint")
    for key in ("m", "v", "master"):
        if key in opt:
            load_named(opt[key], from_jax_layout(cfg, tree["opt"][key]),
                       "the checkpoint")
    opt["step"].copy_(torch.from_numpy(np.asarray(tree["opt"]["step"])))
    return state
