"""The port's sharding layer (``repro_torch.launch.{sharding,mesh}``,
``repro_torch.runtime``) against the JAX package's.

The reference's resolver cases (``tests/test_sharding.py``) and its
property test run against the port's ``resolve_spec`` on the same
stand-in meshes.  For every one of the ten configs, every parameter's
spec (over ``params.param_axes``) equals the reference's over
``spec_axes(param_specs(cfg))`` on the single-pod (16, 16) and the
two-pod (2, 16, 16) production mesh, and every decode-cache leaf's axes
(``cache_axes_for``) are the reference's without their stacked
``"layers"``.  Specs become DTensor placements on a production-sized mesh
of the ``fake`` backend, with local shapes as the spec says and ``("pod",
"data")`` pod-major.  ``runtime.constrain`` is the identity outside a
sharding context and redistributes a DTensor to the resolved placements
inside one; the model's loss inside a context (plain tensors) is the loss
outside it, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # degrade property tests to fixed-seed example sweeps
    from _hypo import given, settings, st

import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models.layers import spec_axes  # noqa: E402
from repro.models.model import param_specs  # noqa: E402
from repro.models.transformer import cache_shapes  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES, batch_axes,  # noqa: E402
                                         cache_axes_for, opt_state_axes,
                                         resolve_spec, spec_placements,
                                         tree_shardings)
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.model import Model, init_params, loss_fn  # noqa: E402
from repro_torch.models.transformer import group_meta, init_cache  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (no devices needed)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


MESH = FakeMesh({"data": 16, "model": 16})
POD_MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})


@pytest.fixture
def fake_world():
    """A default process group of the ``fake`` backend standing for a
    world of ``n`` processes, this one rank ``rank``; torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the reference's resolver cases ---------------------------------------------

def test_default_rules_are_the_references():
    assert DEFAULT_RULES == jsharding.DEFAULT_RULES


@pytest.mark.parametrize("shape,axes,mesh,want", [
    ((8192, 49152), ("embed", "mlp"), MESH, P("data", "model")),
    ((51866, 1280), ("vocab", "embed"), MESH, P(None, "data")),
    ((256, 4096), ("batch", None), POD_MESH, P(("pod", "data"))),
    ((256, 4096), ("batch", None), MESH, P("data")),
    ((1, 524288, 8, 128), ("batch", "cache_seq", "kv_heads", "head_dim"), MESH,
     P(None, "data", None, "model")),
    ((128, 32768, 20, 64), ("batch", "cache_seq", "kv_heads", "head_dim"), MESH,
     P("data", None, None, "model")),
    ((16, 16), ("embed", "embed"), MESH, P("data")),
], ids=["fsdp_tp_weight", "indivisible_replicates", "batch_pod_data",
        "batch_without_pod", "cache_seq_takes_data", "kv_head_fallback",
        "no_duplicate_axis"])
def test_resolve_spec_cases(shape, axes, mesh, want):
    got = resolve_spec(shape, axes, mesh)
    assert got == tuple(want) == tuple(jsharding.resolve_spec(shape, axes, mesh))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.sampled_from(
    [None, "batch", "embed", "mlp", "vocab", "heads", "kv_heads",
     "head_dim", "cache_seq", "layers", "rnn", "q_proj"]),
    min_size=1, max_size=5),
    st.lists(st.sampled_from([1, 2, 7, 16, 20, 56, 64, 256, 4096]),
             min_size=1, max_size=5),
    st.booleans())
def test_property_resolver_sound_and_the_references(axes, dims, multi_pod):
    """Every resolved spec: (1) only names mesh axes, (2) never reuses a mesh
    axis, (3) every sharded dim is divisible by its mesh-axis size; and it is
    the reference's."""
    n = min(len(axes), len(dims))
    axes, dims = tuple(axes[:n]), tuple(dims[:n])
    mesh = POD_MESH if multi_pod else MESH
    sizes = tmesh.mesh_axis_sizes(mesh)
    spec = resolve_spec(dims, axes, mesh)
    assert spec == tuple(jsharding.resolve_spec(dims, axes, mesh))
    used = []
    for dim, part in zip(dims, spec + (None,) * (n - len(spec))):
        if part is None:
            continue
        names = (part,) if isinstance(part, str) else tuple(part)
        total = 1
        for nm in names:
            assert nm in sizes, f"unknown mesh axis {nm}"
            assert nm not in used, f"mesh axis {nm} reused"
            used.append(nm)
            total *= sizes[nm]
        assert dim % total == 0, f"dim {dim} not divisible by {total}"


# -- every config's parameters and caches -------------------------------------------

def _flat(tree, pre=""):
    """{keypath: leaf} of the reference's tree (tuples of axis names and
    ShapeDtypeStructs are leaves)."""
    if isinstance(tree, dict) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], dict)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{pre}/{k}" if pre else str(k)))
        return out
    return {pre: tree}


def _port_stacked_shapes(cfg):
    """{reference keypath: shape} of the port's parameters, stacked layers
    with their leading axis (a model on the meta device)."""
    model = Model(cfg, "meta")
    shapes, reps = {}, {}
    for name, (key, rep) in tparams._jax_keys(
            cfg, dict(model.named_parameters())).items():
        shape = tuple(model.get_parameter(name).shape)
        shapes[key] = shape
        if rep is not None:
            reps[key] = max(reps.get(key, 0), rep + 1)
    return {k: ((reps[k],) + s if k in reps else s) for k, s in shapes.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_are_the_references(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jspecs = param_specs(jcfg)
    jaxes = _flat(spec_axes(jspecs))
    jshapes = {k: tuple(s.shape) for k, s in _flat(jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), jspecs,
        is_leaf=lambda x: hasattr(x, "init"))).items()}
    axes, shapes = tparams.param_axes(cfg), _port_stacked_shapes(cfg)
    assert axes == jaxes
    assert shapes == jshapes
    for mesh in (MESH, POD_MESH):
        for key in axes:
            want = tuple(jsharding.resolve_spec(jshapes[key], jaxes[key], mesh))
            assert resolve_spec(shapes[key], axes[key], mesh) == want, key


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_are_the_references(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    batch, s_buf = 128, 32768
    jshapes = cache_shapes(jcfg, batch, s_buf)
    jaxes = _flat(jsharding.cache_axes_for(jcfg, jshapes))
    jleaves = _flat(jshapes)
    cache = init_cache(cfg, batch, s_buf, device="meta")
    axes = cache_axes_for(cfg, cache)
    where = tparams._layer_index(group_meta(cfg))
    n = 0
    for layer, leaves in enumerate(cache):
        g, _, i = where[layer]
        for name, t in leaves.items():
            key = f"groups/{g}/pos{i}/{name}"
            assert jaxes[key][0] == "layers"
            assert axes[layer][name] == jaxes[key][1:], key
            assert tuple(t.shape) == tuple(jleaves[key].shape)[1:], key
            for mesh in (MESH, POD_MESH):
                # the stacked 'layers' axis is never sharded: the reference's
                # spec is the port's behind one None
                got = resolve_spec(t.shape, axes[layer][name], mesh)
                want = tuple(jsharding.resolve_spec(jleaves[key].shape, jaxes[key], mesh))
                assert want == ((None,) + got if got else ()), key
            n += 1
    assert n == sum(len(v) for v in cache) > 0


def test_batch_and_optimizer_axes():
    batch = {"tokens": torch.zeros(4, 8, device="meta"),
             "pos": torch.zeros((), device="meta")}
    assert batch_axes(batch) == {"tokens": ("batch", None), "pos": ()}
    pa = {"w": ("embed", "mlp")}
    assert opt_state_axes(pa) == {"m": pa, "v": pa, "step": ()}
    assert opt_state_axes(pa, has_master=True)["master"] is pa


# -- meshes and placements ------------------------------------------------------------

def test_production_mesh_needs_its_world(fake_world):
    fake_world(4)
    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh \(16, 16\), "
                                           r"have 4; run under dryrun.py"):
        tmesh.make_production_mesh(device_type="cpu")
    host = tmesh.make_host_mesh(model_parallel=2, device_type="cpu")
    assert tmesh.mesh_axis_sizes(host) == {"data": 2, "model": 2}


def test_production_meshes_on_a_fake_world(fake_world):
    fake_world(512)
    pod = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tmesh.mesh_axis_sizes(pod) == {"pod": 2, "data": 16, "model": 16}
    one = tmesh.make_production_mesh(device_type="cpu")
    assert tmesh.mesh_axis_sizes(one) == {"data": 16, "model": 16}
    assert tmesh.mesh_axis_sizes(MESH) == {"data": 16, "model": 16}


def test_placements_give_local_shapes_pod_major(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    # this process is rank 272 of 512: pod 1, data 1, model 0
    fake_world(512, rank=2 * 16 * 16 // 2 + 16)
    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    spec = resolve_spec((256, 4096), ("batch", None), mesh)
    assert spec == (("pod", "data"),)
    placements = spec_placements(spec, mesh)
    assert placements == (Shard(0), Shard(0), Replicate())
    shape, offset = compute_local_shape_and_global_offset((256, 4096), mesh, placements)
    assert tuple(shape) == (8, 4096)
    assert tuple(offset) == (1 * 128 + 1 * 8, 0)     # pod is the major split
    w = spec_placements(resolve_spec((8192, 4096), ("embed", "mlp"), mesh), mesh)
    assert w == (Replicate(), Shard(0), Shard(1))
    local = distribute_tensor(torch.empty(8192, 4096, device="meta"), mesh, w).to_local()
    assert tuple(local.shape) == (512, 256)
    tree = tree_shardings({"w": torch.empty(8192, 4096, device="meta"),
                           "b": [torch.empty(4096, device="meta")]},
                          {"w": ("embed", "mlp"), "b": [("mlp",)]}, mesh)
    assert tree == {"w": w, "b": [(Replicate(), Replicate(), Shard(0))]}
    with pytest.raises(ValueError, match="mesh's order"):
        spec_placements((("data", "pod"),), mesh)


# -- runtime.constrain --------------------------------------------------------------

def test_constrain_is_the_identity_outside_a_context():
    x = torch.randn(4, 8)
    assert not runtime.active()
    assert runtime.constrain(x, "batch", "heads") is x
    with runtime.sharding_context(MESH):
        assert runtime.active()
        assert runtime.constrain(x, "batch") is x       # a plain tensor
    assert not runtime.active()


def test_constrain_redistributes_a_dtensor(fake_world):
    from torch.distributed.tensor import Replicate, distribute_tensor
    fake_world(256)
    mesh = tmesh.make_production_mesh(device_type="cpu")
    x = distribute_tensor(torch.empty(64, 512, 16, 64, device="meta"), mesh,
                          [Replicate(), Replicate()])
    with runtime.sharding_context(mesh):
        y = runtime.constrain(x, "batch", None, "heads")
    want = spec_placements(resolve_spec(x.shape, ("batch", None, "heads"), mesh), mesh)
    assert tuple(y.placements) == want
    assert tuple(y.to_local().shape) == (4, 512, 1, 64)


def test_model_inside_a_context_is_unchanged():
    cfg = reduced_config("mixtral-8x7b", param_dtype="float32")
    model = init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        out = loss_fn(model, batch)
        with runtime.sharding_context(POD_MESH):
            inside = loss_fn(model, batch)
    assert torch.equal(out, inside)
