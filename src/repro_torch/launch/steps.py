"""Train state and train step of the port.

Counterpart of ``repro/launch/steps.py:56-100`` (``init_state``,
``make_train_step``).  The state is ``{"params": Model, "opt": AdamW
state}``; the step runs forward and chunked loss under autograd, takes the
gradients with ``torch.autograd.grad`` (accumulated in fp32 over
microbatches), and applies the hand-written AdamW in place.
``state_tree`` / ``load_state_tree`` carry the state to and from the
reference's pytree layout (``params/...``, ``opt/m/...``, ``opt/v/...``,
``opt/step``, ``opt/master/...`` by checkpoint keypath), which the
checkpoints of both packages share.  The reference's jit, sharding and HLO
helpers (``jit_train_step``, ``state_specs``, ``compiled_hlo``,
``hlo_cost_provider``) have no counterpart yet.
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
               device: Union[str, torch.device] = "cpu") -> State:
    """Seeded parameters (``models.init_params``) and a fresh AdamW state
    beside them."""
    model = init_params(cfg, seed, device)
    return state_for(model, opt_cfg)


def state_for(model: Model, opt_cfg: adamw.AdamWConfig) -> State:
    """A train state around existing parameters (e.g. carried over from
    the reference by ``from_jax_params``)."""
    return {"params": model,
            "opt": adamw.init(dict(model.named_parameters()), opt_cfg)}


def value_and_grad(model: Model, batch: Batch,
                   remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {parameter name: gradient}) of ``models.model.loss_fn``; the
    parameters are made to take gradients."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


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
