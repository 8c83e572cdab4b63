"""Train state, train / prefill / serve steps, and their sharded forms.

Counterpart of ``repro/launch/steps.py``.  The state is ``{"params":
Model, "opt": AdamW state}``; the train step runs forward and chunked loss
under autograd, takes the gradients with ``torch.autograd.grad``
(accumulated in fp32 over microbatches), and applies the hand-written
AdamW in place.  ``state_tree`` / ``load_state_tree`` carry the state to
and from the reference's pytree layout (``params/...``, ``opt/m/...``,
``opt/v/...``, ``opt/step``, ``opt/master/...`` by checkpoint keypath),
which the checkpoints of both packages share.  ``count_train_step`` counts
one step's costs on the ``meta`` device (the counterpart of
``compiled_hlo``: no HLO, the step's dispatched ops,
``launch.hlo_analysis``) and ``hlo_cost_provider`` turns the count into
the measured cost provider.

``sharded_train_step``, ``sharded_prefill_step`` and
``sharded_serve_step`` are the counterparts of the reference's
``jit_train_step``, ``jit_prefill_step`` and ``jit_serve_step``: nothing is
jitted.  Each returns its step, which runs inside
``runtime.sharding_context(mesh, rules)``, and the step's inputs as
``DTensor``s on the ``meta`` device, placed by ``launch.sharding`` (the
parameters by ``params.named_param_axes``, the AdamW state by
``opt_state_axes``, the batch by ``batch_axes`` and the decode cache by
``cache_axes_for``), where the reference passes shardings to ``jax.jit``.
The step also runs inside DTensor's ``implicit_replication()``: the plain
tensors the model builds on its own (positions, rope tables, masks,
sinusoids, ``arange``s, scalars) meet the DTensors as replicated on the
mesh, as a traced constant is replicated in XLA's SPMD program (the one
choice made for every such site, rather than a ``distribute_tensor`` at
each).  The model's products, lookups and per-head computations run on
the local shards (``runtime``'s docstring); the rest is DTensor's own
sharding propagation.  The serving steps run the reference's plain forms
(``transformer.DRYRUN``), which is what its compiled steps compute.  A train step's gradients are
redistributed onto their parameters' placements (the data-parallel
reduction of a ``Partial``: a reduce-scatter or all-reduce, which a count
sees as a collective).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.config import ModelConfig
from ..models.model import Model, init_params, loss_fn
from ..models.params import (from_jax_layout, load_named, named_param_axes,
                             to_jax_layout)
from ..models.transformer import DRYRUN, KERNELS, Kernels
from ..optim import adamw
from ..runtime import sharding_context
from .mesh import mesh_axis_sizes
from .sharding import (DEFAULT_RULES, batch_axes, cache_axes_for,
                       opt_state_axes, tree_shardings)

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
    return loss.detach(), {n: _placed_like(grads[n], named[n]) for n in named}


def _placed_like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements (a ``Partial``
    reduced: the data-parallel reduction); any other gradient as it is."""
    placements = getattr(param, "placements", None)
    if placements is None or tuple(grad.placements) == tuple(placements):
        return grad
    return grad.redistribute(param.device_mesh, placements)


def _microbatches(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` equal parts of ``x`` along dimension 0.  A DTensor is cut
    shard by shard (part i holds the i-th part of every device's rows), so
    each part keeps the batch's placements and no row moves between
    devices; the reference's reshape into (n, batch / n) and scan reshards
    instead, for the same sum of gradients over the parts."""
    if not hasattr(x, "placements"):
        return list(x.chunk(n))
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(t, x.device_mesh, x.placements, run_check=False)
            for t in x.to_local().chunk(n)]


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
            splits = {k: _microbatches(v, microbatches) for k, v in batch.items()}
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


def make_prefill_step(cfg: ModelConfig, s_buf: Optional[int] = None,
                      kernels: Kernels = KERNELS):
    """(model, batch {"tokens", ["patches"], ["frames"]}) -> (last-position
    logits, decode cache with ``s_buf`` slots, the prompt's length by
    default), through ``kernels``."""
    def prefill_step(model: Model, batch: Batch):
        toks = batch["tokens"]
        return model.prefill(toks, s_buf or toks.shape[1], kernels,
                             patches=batch.get("patches"),
                             frames=batch.get("frames"))
    return prefill_step


def make_serve_step(cfg: ModelConfig, kernels: Kernels = KERNELS):
    """One-token decode step (the ``decode_*`` / ``long_*`` shapes): (model,
    batch {"tokens" (B, 1), "pos", "cache"}) -> {"logits", "cache"}.
    ``pos`` is an int or a 0-d tensor holding one; a tensor without a value
    (on the ``meta`` device) is taken as position 0, since a decode step
    costs the same at every position (it attends over the whole buffer
    under a mask)."""
    def serve_step(model: Model, batch: Batch):
        pos = batch["pos"]
        if isinstance(pos, torch.Tensor):
            pos = 0 if pos.device.type == "meta" else int(pos)
        logits, cache = model.decode_step(batch["tokens"], pos, batch["cache"],
                                          kernels)
        return {"logits": logits, "cache": cache}
    return serve_step


# ---------------------------------------------------------------------------
# Sharded steps (the counterparts of the reference's jit wrappers)
# ---------------------------------------------------------------------------

def state_specs(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """(state on the ``meta`` device, logical-axes tree) for the full train
    state; the axes of ``"params"`` are keyed by parameter name."""
    state = state_for(Model(cfg, "meta"), opt_cfg)
    paxes = named_param_axes(state["params"])
    return state, {"params": paxes,
                   "opt": opt_state_axes(paxes, has_master="master" in state["opt"])}


def shardings_for_batch(cfg: ModelConfig, mesh, batch_shapes):
    """Placements tree of a batch: its leaves by ``batch_axes``, a decode
    cache by ``cache_axes_for``, the position replicated."""
    axes = batch_axes(batch_shapes)
    if "cache" in batch_shapes:
        axes["cache"] = cache_axes_for(cfg, batch_shapes["cache"])
        axes["pos"] = ()
    return tree_shardings(batch_shapes, axes, mesh)


SERVE_FSDP_LIMIT = 10 * 2 ** 30   # replicate weights across 'data' if the
                                  # TP-only shard fits comfortably in HBM


def serve_rules(cfg: ModelConfig, mesh) -> Optional[dict]:
    """Serving has no optimizer state, so FSDP sharding of weights only buys
    HBM at the cost of an all-gather per decoded token.  When the TP-only
    shard fits (most archs; not qwen-110B fp32), drop the 'embed'->data rule
    (EXPERIMENTS.md §Perf, decode hillclimb)."""
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    param_bytes = cfg.total_params() * 4 / tp
    if param_bytes > SERVE_FSDP_LIMIT:
        return None
    rules = dict(DEFAULT_RULES)
    rules["embed"] = ()
    return rules


def _distribute(tree, placements, mesh):
    """The tensors of ``tree`` (nested dicts and lists) as DTensors with the
    matching ``placements``."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements)
    if isinstance(tree, dict):
        return {k: _distribute(v, placements[k], mesh) for k, v in tree.items()}
    return [_distribute(v, p, mesh) for v, p in zip(tree, placements)]


def _distribute_model(model: Model, mesh, rules: Optional[dict] = None) -> Model:
    """``model`` with every parameter replaced, in place, by a DTensor placed
    by its logical axes."""
    named = dict(model.named_parameters())
    placements = tree_shardings(named, named_param_axes(model), mesh, rules)
    for name, p in named.items():
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner), attr, nn.Parameter(
            _distribute(p.data, placements[name], mesh), requires_grad=False))
    return model


def _in_context(step, mesh, rules: Optional[dict] = None):
    """``step`` run inside the sharding context and DTensor's implicit
    replication (the module docstring says why)."""
    @functools.wraps(step)
    def wrapped(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with sharding_context(mesh, rules), implicit_replication():
            return step(*args)
    return wrapped


def sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                       batch_shapes: Batch, microbatches: int = 1):
    """(step, (state, batch)): ``make_train_step`` in the sharding context,
    the train state and ``batch_shapes`` (``models.model.input_specs``) as
    placed DTensors on ``meta``."""
    state, axes = state_specs(cfg, opt_cfg)
    _distribute_model(state["params"], mesh)
    state["opt"] = _distribute(state["opt"], tree_shardings(state["opt"], axes["opt"], mesh),
                               mesh)
    batch = _distribute(batch_shapes, shardings_for_batch(cfg, mesh, batch_shapes), mesh)
    step = _in_context(make_train_step(cfg, opt_cfg, microbatches), mesh)
    return step, (state, batch)


def sharded_prefill_step(cfg: ModelConfig, mesh, batch_shapes: Batch,
                         s_buf: Optional[int] = None):
    """(step, (model, batch)): ``make_prefill_step`` through the reference's
    plain forms in the sharding context, the parameters (by the default
    rules) and the batch as placed DTensors on ``meta``."""
    model = _distribute_model(Model(cfg, "meta"), mesh)
    batch = _distribute(batch_shapes, shardings_for_batch(cfg, mesh, batch_shapes), mesh)
    step = _in_context(make_prefill_step(cfg, s_buf, DRYRUN), mesh)
    return step, (model, batch)


def sharded_serve_step(cfg: ModelConfig, mesh, batch_shapes: Batch):
    """(step, (model, batch)): ``make_serve_step`` through the reference's
    plain forms in the sharding context under ``serve_rules``, the
    parameters (by those rules), the batch and its cache as placed
    DTensors on ``meta``."""
    rules = serve_rules(cfg, mesh)
    model = _distribute_model(Model(cfg, "meta"), mesh, rules)
    batch = _distribute(batch_shapes, shardings_for_batch(cfg, mesh, batch_shapes), mesh)
    step = _in_context(make_serve_step(cfg, DRYRUN), mesh, rules)
    return step, (model, batch)


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
    {...}, "step": array, ["master": {...}]}}`` (numpy copies; a bfloat16
    tensor's bits as ``V2``, so bf16 parameters and moments beside the fp32
    master carry as they are)."""
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
