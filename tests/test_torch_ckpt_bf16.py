"""bfloat16 and mixed-precision checkpoints of the port against the
reference's, on the CPU.

The reduced mixtral-8x7b keeps its bf16 parameters (``param_dtype``) and
the fp32 ``master`` beside them in AdamW's state; its moments are fp32 or,
with ``moment_dtype="bfloat16"``, bf16.  The reference's ``np.savez``
writes an ml_dtypes ``bfloat16`` leaf, which ``np.load`` returns as void
``V2``; the port writes a bf16 tensor's 16-bit patterns viewed as ``V2``.
For the same state the two packages' files load with the same keys, the
same dtypes and the same bits (their npy headers differ, ``'<V2'`` against
``'|V2'``, and are not compared).  Each package restores the other's
checkpoint to the same bits; the port's state round-trips through its own;
a ``V2`` array for a tensor of another dtype raises.  The reference's own
limit is recorded: its ``restore`` hands a bf16 leaf back as ``V2``, which
jax refuses, so it cannot resume its own bf16 run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)
from test_torch_model import flatten  # noqa: E402

ARCH = "mixtral-8x7b"
MOMENTS = ["float32", "bfloat16"]


def _jax_state(moment_dtype):
    """The reference's fresh state with seeded noise on the moments and
    the master, so that no leaf is all zeros or a copy of another."""
    jcfg = jreduced_config(ARCH)
    state = jsteps.init_state(jcfg, jadamw.AdamWConfig(moment_dtype=moment_dtype), seed=0)
    rng = np.random.default_rng(1)

    def noisy(a):
        return (a.astype(jnp.float32) + rng.standard_normal(a.shape).astype(np.float32)
                ).astype(a.dtype)
    opt = dict(state["opt"])
    for key in ("m", "v", "master"):
        opt[key] = jax.tree_util.tree_map(noisy, opt[key])
    return {**state, "opt": opt}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_state(moment_dtype, jstate=None):
    """The port's state holding ``jstate``'s arrays (a fresh one without)."""
    cfg = reduced_config(ARCH)
    jstate = jstate or _jax_state(moment_dtype)
    model = from_jax_params(cfg, flatten(jstate["params"]), device="cpu")
    state = steps.state_for(model, adamw.AdamWConfig(moment_dtype=moment_dtype))
    opt = {k: flatten(jstate["opt"][k]) for k in ("m", "v", "master")}
    return steps.load_state_tree(state, {"params": flatten(jstate["params"]), "opt": {
        **opt, "step": np.array(jstate["opt"]["step"])}})


def _bits(a):
    """(dtype, bytes) of an array; a bfloat16 one, ml_dtypes' or ``V2``, as
    the ``V2`` it loads as."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view("V2")
    return a.dtype.str.replace("<", "|") if a.dtype.kind == "V" else a.dtype.str, a.tobytes()


def _load(path):
    with np.load(path / "step_1" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def _assert_same_bits(a, b):
    assert set(a) == set(b)
    for key in a:
        assert _bits(a[key]) == _bits(b[key]), key


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_saved_arrays_have_the_same_dtypes_and_bits(tmp_path, moment_dtype):
    jstate = _jax_state(moment_dtype)
    jckpt.save(tmp_path / "j", 1, {"state": jstate})
    ckpt.save(tmp_path / "t", 1, {"state": steps.state_tree(_torch_state(moment_dtype, jstate))})
    j, t = _load(tmp_path / "j"), _load(tmp_path / "t")
    _assert_same_bits(j, t)
    dtypes = {k: a.dtype for k, a in t.items()}
    assert dtypes["state/params/embed/table"] == np.dtype("V2")
    assert dtypes["state/opt/master/embed/table"] == np.float32
    assert dtypes["state/opt/m/embed/table"] == (np.dtype("V2") if moment_dtype == "bfloat16"
                                             else np.float32)


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_port_restores_the_references_checkpoint(tmp_path, moment_dtype):
    jstate = _jax_state(moment_dtype)
    jckpt.save(tmp_path, 1, {"state": jstate})
    fresh = _torch_state(moment_dtype)
    tree, _ = ckpt.restore(tmp_path, {"state": steps.state_tree(fresh)})
    steps.load_state_tree(fresh, tree["state"])
    _assert_same_bits(flatten({"state": steps.state_tree(fresh)}),
                      flatten({"state": _host(jstate)}))
    # into bf16 tensors: bf16 tensors of the same bits
    leaf = "state/params/embed/table"
    back, _ = ckpt.restore(tmp_path, {"state": {"params": {"embed": {"table": torch.zeros(
        np.shape(jstate["params"]["embed"]["table"]), dtype=torch.bfloat16)}}}})
    w = back["state"]["params"]["embed"]["table"]
    assert w.dtype == torch.bfloat16
    assert w.view(torch.int16).numpy().tobytes() == _bits(_load(tmp_path)[leaf])[1]


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_reference_restores_the_ports_checkpoint(tmp_path, moment_dtype):
    jstate = _jax_state(moment_dtype)
    ckpt.save(tmp_path, 1, {"state": steps.state_tree(_torch_state(moment_dtype, jstate))})
    tree, _ = jckpt.restore(tmp_path, {"state": _jax_state(moment_dtype)})
    _assert_same_bits(flatten(tree), flatten({"state": _host(jstate)}))


@pytest.mark.parametrize("async_save", [False, True], ids=["save", "AsyncCheckpointer"])
def test_mixed_precision_state_round_trips(tmp_path, async_save):
    """bf16 parameters, the fp32 master and bf16 moments: restored into a
    fresh state, every tensor has its dtype and bits back."""
    state = _torch_state("bfloat16")
    saved = {"state": steps.state_tree(state)}
    if async_save:
        saver = ckpt.AsyncCheckpointer(tmp_path)
        saver.save(1, saved)
        saver.wait()
    else:
        ckpt.save(tmp_path, 1, saved)
    fresh = steps.init_state(reduced_config(ARCH), adamw.AdamWConfig(moment_dtype="bfloat16"),
                             seed=5, device="cpu")
    tree, manifest = ckpt.restore(tmp_path, {"state": steps.state_tree(fresh)})
    steps.load_state_tree(fresh, tree["state"])
    assert manifest["step"] == 1
    pairs = [(dict(state["params"].named_parameters()), dict(fresh["params"].named_parameters()))]
    pairs += [(state["opt"][k], fresh["opt"][k]) for k in ("m", "v", "master")]
    for a, b in pairs:
        assert set(a) == set(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert torch.equal(a[name].view(torch.int16 if a[name].dtype == torch.bfloat16
                                            else torch.int32),
                               b[name].view(torch.int16 if b[name].dtype == torch.bfloat16
                                            else torch.int32)), name
    assert {p.dtype for p in fresh["params"].parameters()} == {torch.bfloat16}
    assert {t.dtype for t in fresh["opt"]["master"].values()} == {torch.float32}
    assert {t.dtype for t in fresh["opt"]["m"].values()} == {torch.bfloat16}
    assert torch.equal(state["opt"]["step"], fresh["opt"]["step"])


def test_bf16_bits_for_another_dtype_raise(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="^w: .*V2.*torch.float32"):
        ckpt.restore(tmp_path, {"w": torch.zeros(3)})
    # a numpy template takes the V2 array as it is, as the reference's does
    tree, _ = ckpt.restore(tmp_path, {"w": np.zeros(3)})
    assert tree["w"].dtype == np.dtype("V2")


def test_reference_cannot_resume_its_own_bf16_leaves(tmp_path):
    """The reference's limit: its restore hands a bf16 leaf back as ``V2``
    (uncast), which jax refuses."""
    w = jnp.arange(4, dtype=jnp.bfloat16)
    jckpt.save(tmp_path, 1, {"w": w})
    tree, _ = jckpt.restore(tmp_path, {"w": w})
    assert tree["w"].dtype == np.dtype("V2")
    assert tree["w"].tobytes() == np.asarray(w).tobytes()
    with pytest.raises(TypeError, match="V2"):
        jnp.asarray(tree["w"])
