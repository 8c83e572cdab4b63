"""The port's checkpoints against the reference's on the CPU.

Both packages write ``step_<N>/arrays.npz`` + ``manifest.json`` under the
same keypaths (``state/params/groups/0/pos0/attn/wq/w``,
``state/opt/m/...``, ``state/opt/step``), so a checkpoint written by either
restores in the other: restoring one checkpoint through both packages
gives equal arrays and equal manifests, in both directions.  Also: atomic
re-save of a step, ``_gc(keep)``, the reserved manifest keys,
``AsyncCheckpointer`` (host snapshot at ``save``, failures re-raised), and
a bfloat16 leaf's round trip (its bits as ``V2``; into a tensor of another
dtype it raises).  ``tests/test_torch_ckpt_bf16.py`` holds bf16 and
mixed-precision states against the reference's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.data.pipeline import SyntheticTokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)
from test_torch_model import flatten  # noqa: E402

ARCH = "yi-34b"
KW = dict(lr=1e-2, warmup_steps=2, decay_steps=10)


def _batch(i):
    return SyntheticTokens(reduced_config(ARCH).vocab_size, 2, 8, seed=1).batch_at(i)


def _jax_state(n_steps):
    jcfg, jopt = jreduced_config(ARCH), jadamw.AdamWConfig(**KW)
    state = jsteps.init_state(jcfg, jopt, seed=0)
    step = jax.jit(jsteps.make_train_step(jcfg, jopt))
    for i in range(n_steps):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in _batch(i).items()})
    return state


def _torch_state(n_steps):
    cfg, opt = reduced_config(ARCH), adamw.AdamWConfig(**KW)
    model = from_jax_params(cfg, flatten(_jax_state(0)["params"]), device="cpu")
    state = steps.state_for(model, opt)
    step = steps.make_train_step(cfg, opt)
    for i in range(n_steps):
        state, _ = step(state, {k: torch.from_numpy(v).long() for k, v in _batch(i).items()})
    return state


def _restore_both(path):
    """The latest checkpoint under ``path`` restored by each package into
    its own template: (reference arrays, port arrays, manifests)."""
    jtree, jman = jckpt.restore(path, {"state": _jax_state(0)})
    ttree, tman = ckpt.restore(path, {"state": steps.state_tree(_torch_state(0))})
    return flatten(jtree), flatten(ttree), jman, tman


def _assert_same_arrays(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


def test_port_checkpoint_restores_in_reference(tmp_path):
    state = _torch_state(2)
    saved = flatten({"state": steps.state_tree(state)})
    ckpt.save(tmp_path, 2, {"state": steps.state_tree(state)}, extra={"data": {"step": 2}})
    jflat, tflat, jman, tman = _restore_both(tmp_path)
    _assert_same_arrays(jflat, saved)
    _assert_same_arrays(tflat, saved)
    assert jman == tman and jman["step"] == 2 and jman["data"] == {"step": 2}
    # loaded back into a train state, the arrays are the saved ones
    fresh = _torch_state(0)
    steps.load_state_tree(fresh, ckpt.restore(tmp_path, {"state": steps.state_tree(fresh)})[0]["state"])
    _assert_same_arrays(flatten({"state": steps.state_tree(fresh)}), saved)


def test_reference_checkpoint_restores_in_port(tmp_path):
    jstate = _jax_state(2)
    jckpt.save(tmp_path, 2, {"state": jstate}, extra={"data": {"step": 2}})
    jflat, tflat, jman, tman = _restore_both(tmp_path)
    _assert_same_arrays(tflat, jflat)
    assert jman == tman
    state = steps.load_state_tree(_torch_state(0),
                                  ckpt.restore(tmp_path, {"state": steps.state_tree(_torch_state(0))})[0]["state"])
    _assert_same_arrays(flatten({"state": steps.state_tree(state)}),
                        flatten({"state": jax.tree_util.tree_map(np.asarray, jstate)}))


def test_manifests_count_the_same_arrays(tmp_path):
    ckpt.save(tmp_path / "t", 1, {"state": steps.state_tree(_torch_state(1))})
    jckpt.save(tmp_path / "j", 1, {"state": _jax_state(1)})
    read = lambda d: json.loads((tmp_path / d / "step_1" / ckpt.MANIFEST).read_text())
    t, j = read("t"), read("j")
    assert (t["n_arrays"], t["total_bytes"]) == (j["n_arrays"], j["total_bytes"])


def test_resave_is_atomic_and_keeps_the_new_arrays(tmp_path):
    ckpt.save(tmp_path, 3, {"w": np.zeros(4)})
    ckpt.save(tmp_path, 3, {"w": np.ones(4)})
    tree, man = ckpt.restore(tmp_path, {"w": np.zeros(4)})
    assert np.array_equal(tree["w"], np.ones(4)) and man["step"] == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3"]


def test_gc_keeps_the_newest_and_sweeps_stale_dirs(tmp_path):
    (tmp_path / ".tmp_step_9_1").mkdir(parents=True)
    (tmp_path / ".old_step_8_1").mkdir()
    for s in range(1, 6):
        ckpt.save(tmp_path, s, {"w": np.full(2, s)}, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_5"]
    assert ckpt.latest_step(tmp_path) == 5
    (tmp_path / "step_7").mkdir()            # no manifest: invisible
    assert ckpt.latest_step(tmp_path) == 5


@pytest.mark.parametrize("key", sorted(ckpt.RESERVED_MANIFEST_KEYS))
def test_reserved_manifest_keys_raise(tmp_path, key):
    assert ckpt.RESERVED_MANIFEST_KEYS == jckpt.RESERVED_MANIFEST_KEYS
    with pytest.raises(ValueError, match="collide"):
        ckpt.save(tmp_path, 1, {"w": np.zeros(1)}, extra={key: 0})


def test_restore_checks_shape_and_presence(tmp_path):
    ckpt.save(tmp_path, 1, {"w": np.zeros(3), "n": 4})
    tree, _ = ckpt.restore(tmp_path, {"w": torch.ones(3), "n": 0})
    assert isinstance(tree["w"], torch.Tensor) and tree["n"] == 4
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, {"w": np.zeros(2)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(tmp_path, {"v": np.zeros(3)})


def test_async_checkpointer_snapshots_at_save(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=3)
    w = torch.zeros(5)
    saver.save(1, {"w": w})
    w.add_(1.0)                              # after save(): not in the checkpoint
    saver.wait()
    assert saver.last_path == tmp_path / "step_1"
    tree, _ = ckpt.restore(tmp_path, {"w": np.zeros(5)})
    assert np.array_equal(tree["w"], np.zeros(5))


def test_async_checkpointer_reraises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(blocker)
    saver.save(1, {"w": np.zeros(2)})
    with pytest.raises(OSError):
        saver.wait()
    assert saver.last_path is None
    saver.wait()                             # raised once, then cleared


def test_bf16_leaf_raises(tmp_path):
    """A bf16 leaf is saved (by ``save`` and ``AsyncCheckpointer``) as its
    bits viewed as ``V2`` and restored into a bf16 tensor bit for bit; it
    raises only where the template's tensor has another dtype."""
    w = torch.tensor([1.0, -2.5, 3e-3, float("inf")]).to(torch.bfloat16)
    ckpt.save(tmp_path / "sync", 1, {"w": w})
    saver = ckpt.AsyncCheckpointer(tmp_path / "async")
    saver.save(1, {"w": w})
    saver.wait()
    for d in ("sync", "async"):
        with np.load(tmp_path / d / "step_1" / "arrays.npz") as z:
            assert z["w"].dtype == np.dtype("V2")
        tree, _ = ckpt.restore(tmp_path / d, {"w": torch.zeros(4, dtype=torch.bfloat16)})
        assert tree["w"].dtype == torch.bfloat16
        assert torch.equal(tree["w"].view(torch.int16), w.view(torch.int16))
        with pytest.raises(TypeError, match="w: the checkpoint holds bfloat16 bits"):
            ckpt.restore(tmp_path / d, {"w": torch.zeros(4)})
