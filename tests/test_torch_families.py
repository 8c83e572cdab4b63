"""The decoder-only families of the port against the JAX package, on the CPU:
gemma2-27b (alternating local/global attention, sandwich norms, attention
and logit softcaps, query scale, tied embeddings), nemotron-4-15b
(layernorm, squared ReLU, GQA 6), qwen1.5-110b (QKV bias) and pixtral-12b
(the vision stub: projected patch embeddings replace the first
``n_patches`` positions).

Parameters come from the reference's ``init_params`` (by checkpoint
keypath, ``from_jax_params``); tokens and patches from a numpy seed.  Each
reduced model runs a prefill (logits and the whole decode cache compared)
and eight decode steps on the reference's greedy tokens: at fp32 the
logits agree to 1e-4 and the greedy tokens are identical; at bf16 to rtol
5e-2, atol 1e-1 times the logits' rms where it exceeds 1 (gemma2's tied
embedding gives logits of rms ~8, as recurrentgemma's does).  The prompt
(20) is longer than the reduced window (16), so the ring buffer wraps.
``check_prefill_and_decode`` also holds the MoE families
(``tests/test_torch_moe.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import from_jax_params, init_params  # noqa: E402
from repro_torch.models.transformer import layer_cache_shape  # noqa: E402
from test_torch_model import flatten  # noqa: E402
from test_torch_rglru import _close_caches, _np  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=1e-1)}
B, S, STEPS = 2, 20, 8          # S > the reduced window (16): the ring wraps
ARCHS = ["gemma2-27b", "nemotron-4-15b", "qwen1.5-110b", "pixtral-12b"]

# jitted once per config: the reference's eager scan over layers would
# compile its body at every call
_JPREFILL = jax.jit(jprefill, static_argnums=(1, 3))
_JDECODE = jax.jit(jdecode_step, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    """The reference's parameters of the reduced ``arch`` (seed 0); its
    compute dtype does not change them."""
    return jinit_params(jreduced_config(arch), 0)


def _logits_tol(tol, compute_dtype, j_logits):
    if compute_dtype == "float32":
        return tol
    rms = float(np.sqrt(np.mean(_np(j_logits) ** 2)))
    return dict(tol, atol=tol["atol"] * max(1.0, rms))


def _patches(cfg, compute_dtype, seed=9):
    p = np.random.default_rng(seed).standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(p).astype(getattr(jnp, compute_dtype)),
            torch.from_numpy(p).to(getattr(torch, compute_dtype)))


def check_prefill_and_decode(arch, compute_dtype):
    """Prefill (logits and cache) and ``STEPS`` decode steps of the reduced
    ``arch`` against the reference."""
    jcfg = jreduced_config(arch, compute_dtype=compute_dtype)
    cfg = reduced_config(arch, compute_dtype=compute_dtype)
    params = reference_params(arch)
    model = from_jax_params(cfg, flatten(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    s_buf = S + STEPS
    tol = TOL[compute_dtype]

    j_logits, j_cache = _JPREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32), s_buf)
    t_logits, t_cache = model.prefill(torch.from_numpy(tokens), s_buf)
    assert t_logits.shape == (B, 1, cfg.vocab_size) and t_logits.dtype == torch.float32
    ltol = _logits_tol(tol, compute_dtype, j_logits)
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **ltol)
    _close_caches(t_cache, j_cache, cfg, tol)

    j_tok = jnp.argmax(j_logits[:, -1:], axis=-1).astype(jnp.int32)
    t_tok = t_logits[:, -1:].argmax(-1)
    for step in range(STEPS):
        if compute_dtype == "float32":
            np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        pos = S + step
        j_logits, j_cache = _JDECODE(params, jcfg, j_tok, jnp.asarray(pos, jnp.int32),
                                     j_cache)
        t_logits, t_cache = model.decode_step(torch.from_numpy(np.array(j_tok)).long(),
                                              pos, t_cache)
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), **ltol)
        j_tok = jnp.argmax(j_logits, axis=-1).astype(jnp.int32)
        t_tok = t_logits.argmax(-1)
    _close_caches(t_cache, j_cache, cfg, tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, compute_dtype):
    check_prefill_and_decode(arch, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pixtral_prefill_with_patches_matches_reference(compute_dtype):
    jcfg = jreduced_config("pixtral-12b", compute_dtype=compute_dtype)
    cfg = reduced_config("pixtral-12b", compute_dtype=compute_dtype)
    params = reference_params("pixtral-12b")
    model = from_jax_params(cfg, flatten(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    jp, tp = _patches(cfg, compute_dtype)
    j_logits, j_cache = _JPREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32), S + 4, jp)
    t_logits, t_cache = model.prefill(torch.from_numpy(tokens), S + 4, patches=tp)
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **tol)
    _close_caches(t_cache, j_cache, cfg, tol)
    # the patches reach the model: without them the logits differ
    plain, _ = model.prefill(torch.from_numpy(tokens), S + 4)
    assert float((plain - t_logits).abs().max()) > 1e-2


def test_patches_replace_the_first_positions():
    """The projected patches stand in the first ``n_patches`` positions;
    the later ones are the token embeddings (fp32, the port alone)."""
    from repro_torch.models.model import _embed_inputs
    cfg = reduced_config("pixtral-12b", compute_dtype="float32")
    model = init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    _, tp = _patches(cfg, "float32")
    x = _embed_inputs(model, tokens, tp)
    plain = _embed_inputs(model, tokens)
    torch.testing.assert_close(x[:, :cfg.n_patches], tp @ model.patch_proj.w)
    torch.testing.assert_close(x[:, cfg.n_patches:], plain[:, cfg.n_patches:])


def test_post_norms_are_held_and_applied():
    """gemma2's blocks hold post1/post2 (the reference's ``block_spec``
    keys); a nonzero post-norm scale changes the output, so they are
    applied."""
    cfg = reduced_config("gemma2-27b", compute_dtype="float32")
    model = init_params(cfg, 0, "cpu")
    names = set(model.state_dict())
    for i in range(cfg.n_layers):
        assert {f"layers.{i}.post1.scale", f"layers.{i}.post2.scale"} <= names
    assert not any(".post" in n for n in init_params(reduced_config("yi-34b"), 0, "cpu")
                   .state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    before, _ = model.prefill(tokens, S)
    with torch.no_grad():
        model.layers[1].post2.scale.fill_(0.5)
    after, _ = model.prefill(tokens, S)
    assert not torch.allclose(before, after)


@pytest.mark.parametrize("arch", ["gemma2-27b", "mixtral-8x7b"])
def test_local_kinds_keep_a_window_ring(arch):
    """``local`` and ``moe_local`` layers attend within the window and
    cache a ring of its size; ``global`` layers a full buffer."""
    cfg = get_config(arch)
    assert cfg.window == 4096
    for kind in set(cfg.layer_kinds):
        spec = layer_cache_shape(cfg, kind, 2, 8240)["k"]
        slots = 4096 if kind.endswith("local") else 8240
        assert spec == ((2, slots, cfg.n_kv_heads, cfg.d_head), torch.bfloat16), kind


@pytest.mark.parametrize("arch", ["gemma2-27b", "mixtral-8x7b"])
def test_prefill_then_decode_matches_longer_prefill(arch):
    """Decoding token S after a prefill of S tokens gives the logits of a
    prefill of S + 1 tokens (the port against itself, fp32), with the
    window's ring wrapped.  MoE at ``capacity_factor = n_experts``: the
    default drops oversubscribed tokens in a long prefill that one decoded
    token never meets."""
    cfg = dataclasses.replace(reduced_config(arch, compute_dtype="float32",
                                             param_dtype="float32"),
                              capacity_factor=4.0)
    model = init_params(cfg, 1, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)))
    want, _ = model.prefill(tokens, S + 1)
    _, cache = model.prefill(tokens[:, :S], S + 4)
    got, _ = model.decode_step(tokens[:, S:], S, cache)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
