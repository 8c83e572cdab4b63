"""whisper-large-v3, the encoder-decoder, against the JAX package on the CPU.

All comparisons run on the reduced whisper (2 encoder and 2 decoder layers,
24 frames) with the reference's parameters carried across by checkpoint
keypath (``from_jax_params``: ``enc_groups/0/pos0/...``, ``enc_norm``,
``frame_proj``, the decoder's ``cross`` and ``ln_cross``); tokens and frame
embeddings come from a numpy seed and reach both packages in the compute
dtype, as the reference's ``input_specs`` gives the audio stub's frames.

Held here: the encoder alone (``_encode``, through the plain ``mha`` and
through the serving path's attention); a prefill (logits, the self-attention
cache and the cross cache ``cross_k`` / ``cross_v``) and eight decode steps,
at the tolerances of ``tests/test_torch_families.py`` (fp32 1e-4, greedy
tokens identical; bf16 rtol 5e-2, atol 1e-1); loss and every gradient leaf
with frames against ``jax.value_and_grad`` of the reference's ``loss_fn``,
in the per-entry and relative-norm form of ``tests/test_torch_train.py``;
the parameter round trip key for key; a checkpoint written by either
package restored by the other; the trainer's refusal (the reference's
trainer has no frames to give whisper, so neither has the port's).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.model as jmodel  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
import repro_torch.models.model as tmodel  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import from_jax_params, init_params  # noqa: E402
from repro_torch.models.params import to_jax_layout, to_jax_params  # noqa: E402
from repro_torch.models.transformer import KERNELS, init_cache  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401  (autouse)
from test_torch_families import TOL  # noqa: E402
from test_torch_model import flatten  # noqa: E402
from test_torch_rglru import _close_caches, _np  # noqa: E402
from test_torch_train import GRAD_TOL, LOSS_RTOL, _check_grads  # noqa: E402

ARCH = "whisper-large-v3"
B, S, STEPS = 2, 12, 8
REPO = Path(__file__).resolve().parent.parent

_JPREFILL = jax.jit(jmodel.prefill, static_argnums=(1, 3))
_JDECODE = jax.jit(jmodel.decode_step, static_argnums=(1,))
_JENCODE = jax.jit(jmodel._encode, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def reference_params():
    return jinit_params(jreduced_config(ARCH), 0)


def _configs(compute_dtype):
    return (jreduced_config(ARCH, compute_dtype=compute_dtype),
            reduced_config(ARCH, compute_dtype=compute_dtype))


def _frames(cfg, compute_dtype, seed=5, b=B):
    """The same frame embeddings for both packages, in the compute dtype."""
    f = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(f).astype(getattr(jnp, compute_dtype)),
            torch.from_numpy(f).to(getattr(torch, compute_dtype)))


def _model(cfg):
    return from_jax_params(cfg, flatten(reference_params()), device="cpu")


def test_configs_mirror_reference():
    """The published whisper config and its reduced one equal the
    reference's field by field; the published widths are arXiv:2212.04356's."""
    import dataclasses
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(reduced_config(ARCH)) == dataclasses.asdict(jreduced_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head,
            cfg.d_ff, cfg.vocab_size, cfg.encoder_seq) == (32, 32, 1280, 20, 64, 5120,
                                                           51_866, 1500)
    assert (cfg.mlp_act, cfg.norm, cfg.use_rope, cfg.frontend) == (
        "gelu", "layernorm", False, "audio_stub")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(compute_dtype):
    """The encoder alone: frame_proj, sinusoidal positions, two non-causal
    blocks, enc_norm; through the plain ``mha`` (training's) and through
    the serving path's attention (``KERNELS``: its plain version on the
    CPU)."""
    jcfg, cfg = _configs(compute_dtype)
    model = _model(cfg)
    jf, tf = _frames(cfg, compute_dtype)
    want = _np(_JENCODE(reference_params(), jcfg, jf))
    with torch.no_grad():
        plain = tmodel._encode(model, tf)
        served = tmodel._encode(model, tf, KERNELS)
    assert plain.shape == (B, cfg.encoder_seq, cfg.d_model)
    assert plain.dtype == getattr(torch, compute_dtype)
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(_np(plain), want, **tol)
    np.testing.assert_allclose(_np(served), want, **tol)


def _prefill_both(compute_dtype, s_buf):
    jcfg, cfg = _configs(compute_dtype)
    params = reference_params()
    model = _model(cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    jf, tf = _frames(cfg, compute_dtype)
    j = _JPREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32), s_buf, None, jf)
    t = model.prefill(torch.from_numpy(tokens), s_buf, frames=tf)
    return jcfg, cfg, params, model, j, t


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(compute_dtype):
    s_buf = S + STEPS
    jcfg, cfg, params, model, (j_logits, j_cache), (t_logits, t_cache) = \
        _prefill_both(compute_dtype, s_buf)
    tol = TOL[compute_dtype]
    assert t_logits.shape == (B, 1, cfg.vocab_size) and t_logits.dtype == torch.float32
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **tol)
    _close_caches(t_cache, j_cache, cfg, tol)

    j_tok = jnp.argmax(j_logits[:, -1:], axis=-1).astype(jnp.int32)
    t_tok = t_logits[:, -1:].argmax(-1)
    for step in range(STEPS):
        if compute_dtype == "float32":
            np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        pos = S + step
        j_logits, j_cache = _JDECODE(params, jcfg, j_tok, jnp.asarray(pos, jnp.int32), j_cache)
        t_logits, t_cache = model.decode_step(torch.from_numpy(np.array(j_tok)).long(),
                                              pos, t_cache)
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), **tol)
        j_tok = jnp.argmax(j_logits, axis=-1).astype(jnp.int32)
        t_tok = t_logits.argmax(-1)
    _close_caches(t_cache, j_cache, cfg, tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cross_cache_matches_reference(compute_dtype):
    """Each decoder layer's cross cache is its cross-attention's K and V of
    the encoder's output, (B, encoder_seq, K, dh) in the compute dtype,
    as the reference's; decode leaves it as it is."""
    jcfg, cfg, params, model, (_, j_cache), (_, t_cache) = _prefill_both(compute_dtype, S + 2)
    tol = TOL[compute_dtype]
    shape = (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.d_head)
    for i, layer in enumerate(t_cache):
        for name in ("cross_k", "cross_v"):
            assert tuple(layer[name].shape) == shape
            assert layer[name].dtype == getattr(torch, compute_dtype)
            np.testing.assert_allclose(
                _np(layer[name]), _np(j_cache["groups"][0]["pos0"][name][i]), **tol)
    before = [layer["cross_k"].clone() for layer in t_cache]
    model.decode_step(torch.zeros((B, 1), dtype=torch.long), S, t_cache)
    for layer, k in zip(t_cache, before):
        assert torch.equal(layer["cross_k"], k)
    # init_cache lays out the same tensors
    empty = init_cache(cfg, B, S + 2, device="cpu")
    assert [sorted(c) for c in empty] == [sorted(c) for c in t_cache]
    assert tuple(empty[0]["cross_v"].shape) == shape


def test_prefill_then_decode_matches_longer_prefill():
    """Decoding token S after a prefill of S tokens gives the logits of a
    prefill of S + 1 tokens on the same frames (the port against itself,
    fp32)."""
    cfg = reduced_config(ARCH, compute_dtype="float32")
    model = init_params(cfg, 1, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)))
    _, frames = _frames(cfg, "float32", seed=4)
    want, _ = model.prefill(tokens, S + 1, frames=frames)
    _, cache = model.prefill(tokens[:, :S], S + 4, frames=frames)
    got, _ = model.decode_step(tokens[:, S:], S, cache)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_frames_are_required_and_reach_the_model():
    cfg = reduced_config(ARCH, compute_dtype="float32")
    model = init_params(cfg, 0, "cpu")
    tokens = torch.zeros((B, S), dtype=torch.long)
    with pytest.raises(ValueError, match="whisper-large-v3 is an encoder-decoder"):
        model.prefill(tokens, S)
    _, f1 = _frames(cfg, "float32", seed=1)
    _, f2 = _frames(cfg, "float32", seed=2)
    a, _ = model.prefill(tokens, S, frames=f1)
    b, _ = model.prefill(tokens, S, frames=f2)
    assert float((a - b).abs().max()) > 1e-3


def _reference_grads(jcfg, batch, jframes):
    fn = jax.jit(jax.value_and_grad(jmodel.loss_fn), static_argnums=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["frames"] = jframes
    loss, grads = fn(reference_params(), jcfg, jb)
    return float(loss), flatten(grads)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(compute_dtype):
    """Loss and every gradient leaf (encoder, frame_proj, cross-attention
    included) with frames in the batch."""
    jcfg, cfg = _configs(compute_dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jf, tf = _frames(cfg, compute_dtype, seed=6)
    jloss, jgrads = _reference_grads(jcfg, batch, jf)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tb["frames"] = tf
    loss, grads = steps.value_and_grad(_model(cfg), tb)
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL[compute_dtype])
    got = to_jax_layout(cfg, {n: g.float() for n, g in grads.items()})
    assert set(got) == set(jgrads)
    assert float(np.abs(got["frame_proj/w"]).max()) > 0
    assert float(np.abs(got["groups/0/pos0/cross/wk/w"]).max()) > 0
    _check_grads(got, jgrads, *GRAD_TOL[compute_dtype])


def test_params_round_trip_key_for_key():
    flat = flatten(reference_params())
    assert {"frame_proj/w", "enc_norm/scale", "enc_groups/0/pos0/attn/wq/w",
            "groups/0/pos0/cross/wv/w", "groups/0/pos0/ln_cross/bias"} <= set(flat)
    model = _model(reduced_config(ARCH))
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["enc_layers.1.mlp.wi.w"].numpy(),
                                  flat["enc_groups/0/pos0/mlp/wi/w"][1])
    np.testing.assert_array_equal(sd["layers.0.cross.wq.w"].numpy(),
                                  flat["groups/0/pos0/cross/wq/w"][0])
    back = to_jax_params(model)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key


KW = dict(lr=1e-2, warmup_steps=2, decay_steps=10)


def _train_batch(cfg, i):
    toks = np.random.default_rng(20 + i).integers(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    frames = np.random.default_rng(40 + i).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


def _jax_state(n_steps):
    jcfg, jopt = jreduced_config(ARCH, compute_dtype="float32"), jadamw.AdamWConfig(**KW)
    state = jsteps.init_state(jcfg, jopt, seed=0)
    step = jax.jit(jsteps.make_train_step(jcfg, jopt))
    for i in range(n_steps):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in _train_batch(jcfg, i).items()})
    return state


def _torch_state(n_steps):
    cfg, opt = reduced_config(ARCH, compute_dtype="float32"), adamw.AdamWConfig(**KW)
    model = from_jax_params(cfg, flatten(_jax_state(0)["params"]), device="cpu")
    state = steps.state_for(model, opt)
    step = steps.make_train_step(cfg, opt)
    for i in range(n_steps):
        batch = _train_batch(cfg, i)
        tb = {k: torch.from_numpy(v) if k == "frames" else torch.from_numpy(v).long()
              for k, v in batch.items()}
        state, _ = step(state, tb)
    return state


def _assert_same_arrays(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A whisper train state after one step with frames, saved by either
    package, restores in the other to the same arrays."""
    if writer == "port":
        saved = steps.state_tree(_torch_state(1))
        ckpt.save(tmp_path, 1, {"state": saved})
        saved = flatten({"state": saved})
    else:
        jstate = _jax_state(1)
        jckpt.save(tmp_path, 1, {"state": jstate})
        saved = flatten({"state": jax.tree_util.tree_map(np.asarray, jstate)})
    assert any(k.startswith("state/params/enc_groups/") for k in saved)
    assert "state/opt/m/frame_proj/w" in saved
    jtree, _ = jckpt.restore(tmp_path, {"state": _jax_state(0)})
    fresh = _torch_state(0)
    ttree, _ = ckpt.restore(tmp_path, {"state": steps.state_tree(fresh)})
    _assert_same_arrays(flatten(jtree), saved)
    _assert_same_arrays(flatten(ttree), saved)
    steps.load_state_tree(fresh, ttree["state"])
    _assert_same_arrays(flatten({"state": steps.state_tree(fresh)}), saved)


def test_reference_trainer_has_no_frames_for_whisper():
    """The reference's trainer feeds token batches only: for whisper it
    fails before its first step, for want of frames."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, "-m", "repro.launch.train", "--arch", ARCH,
                          "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                          "--analyze-every", "2"],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert "frames" in out.stderr
    assert "[step 1]" not in out.stdout


def test_port_trainer_refuses_whisper_before_its_first_step(capsys):
    """So the port's trainer refuses it, naming whisper and the frames,
    before it builds a model or takes a step."""
    with pytest.raises(SystemExit):
        train.run(["--arch", ARCH, "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr()
    assert "--arch whisper-large-v3" in out.err and "frame" in out.err
    assert "[step 1]" not in out.out and "[train]" not in out.out
