"""The port's model against the JAX package's on the CPU.

Parameters come from the reference's ``init_params`` and are carried
across by checkpoint keypath (``models.params.from_jax_params``); tokens
are drawn from a numpy seed.  Prefill logits and the KV cache, then eight
decode steps, are compared on the reduced yi-34b and on a GQA variant of it
(the plain reduced config has as many KV heads as query heads).  In float32
the logits agree to 1e-4 and the greedy tokens are identical; in bfloat16
to the JAX package's own prefill/decode tolerance (rtol 5e-2, atol 1e-1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model, from_jax_params, init_params  # noqa: E402
from repro_torch.models.transformer import Block, init_cache  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=1e-1)}
VARIANTS = {"yi-reduced": {}, "yi-reduced-gqa": dict(n_heads=8, n_kv_heads=2)}
B, S, STEPS = 2, 12, 8


def flatten(tree):
    """Checkpoint keypaths, as ``repro/ckpt/checkpoint.py`` joins them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _configs(variant, compute_dtype):
    kw = dict(VARIANTS[variant], compute_dtype=compute_dtype)
    return jreduced_config("yi-34b", **kw), reduced_config("yi-34b", **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_configs_mirror_reference():
    """All ten published configs, and their reduced configs, equal the
    reference's field by field."""
    assert len(list_archs()) == 10
    for name in list_archs():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name))
        assert dataclasses.asdict(reduced_config(name)) == \
            dataclasses.asdict(jreduced_config(name))
    for kw in VARIANTS.values():
        assert dataclasses.asdict(reduced_config("yi-34b", **kw)) == \
            dataclasses.asdict(jreduced_config("yi-34b", **kw))


def test_unported_arch_raises():
    """Every architecture of the reference is registered, whisper-large-v3
    the last; a name the registry does not hold raises."""
    from repro.configs import ARCH_MODULES as JARCH_MODULES
    assert list_archs() == tuple(JARCH_MODULES)
    assert list_archs()[-1] == "whisper-large-v3"
    with pytest.raises(KeyError, match="unknown architecture 'llama-99b'"):
        get_config("llama-99b")


def test_params_carry_across_exactly():
    jcfg, cfg = _configs("yi-reduced-gqa", "bfloat16")
    flat = flatten(jinit_params(jcfg, 0))
    model = from_jax_params(cfg, flat, device="cpu")
    sd = model.state_dict()
    assert len(sd) == 3 + 9 * cfg.n_layers
    np.testing.assert_array_equal(sd["layers.1.attn.wk.w"].numpy(),
                                  flat["groups/0/pos0/attn/wk/w"][1])
    np.testing.assert_array_equal(sd["embed.table"].numpy(), flat["embed/table"])
    with pytest.raises(KeyError):
        from_jax_params(cfg, {k: v for k, v in flat.items() if k != "logits/w"}, device="cpu")


def test_bf16_params_carry_bit_for_bit():
    jcfg, cfg = _configs("yi-reduced", "bfloat16")
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    flat = flatten(jinit_params(jcfg, 0))
    model = from_jax_params(cfg, flat, device="cpu")
    w = model.state_dict()["layers.0.mlp.wo.w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  flat["groups/0/pos0/mlp/wo/w"][0].astype(np.float32))


def test_init_params_is_seeded():
    cfg = reduced_config("yi-34b")
    a, b = init_params(cfg, 3, "cpu"), init_params(cfg, 3, "cpu")
    c = init_params(cfg, 4, "cpu")
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        if "scale" not in name:
            assert not torch.equal(x, z), name
    assert float(a.state_dict()["layers.0.ln1.scale"].abs().sum()) == 0.0
    w = a.state_dict()["layers.0.mlp.wi.w"]
    assert abs(float(w.std()) - 1 / np.sqrt(cfg.d_model)) < 0.02


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant, compute_dtype):
    jcfg, cfg = _configs(variant, compute_dtype)
    params = jinit_params(jcfg, 0)
    model = from_jax_params(cfg, flatten(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    s_buf = S + STEPS
    tol = TOL[compute_dtype]

    j_logits, j_cache = jprefill(params, jcfg, jnp.asarray(tokens, jnp.int32), s_buf)
    t_logits, t_cache = model.prefill(torch.from_numpy(tokens), s_buf)
    assert t_logits.shape == (B, 1, cfg.vocab_size) and t_logits.dtype == torch.float32
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **tol)
    for i, layer in enumerate(t_cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(layer[name]), _np(j_cache["groups"][0]["pos0"][name][i]), **tol)

    # decode: the same token stream into both (the reference's greedy choice)
    j_tok = jnp.argmax(j_logits[:, -1:], axis=-1).astype(jnp.int32)
    t_tok = t_logits[:, -1:].argmax(-1)
    for step in range(STEPS):
        if compute_dtype == "float32":
            np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        pos = S + step
        j_logits, j_cache = jdecode_step(params, jcfg, j_tok,
                                         jnp.asarray(pos, jnp.int32), j_cache)
        t_logits, t_cache = model.decode_step(torch.from_numpy(np.array(j_tok)).long(),
                                              pos, t_cache)
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), **tol)
        j_tok = jnp.argmax(j_logits, axis=-1).astype(jnp.int32)
        t_tok = t_logits.argmax(-1)


def test_prefill_then_decode_matches_longer_prefill():
    """Decoding token S after a prefill of S tokens gives the logits of a
    prefill of S + 1 tokens (the port against itself, float32)."""
    cfg = reduced_config("yi-34b", n_heads=8, n_kv_heads=2, compute_dtype="float32")
    model = init_params(cfg, 1, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)))
    want, _ = model.prefill(tokens, S + 1)
    _, cache = model.prefill(tokens[:, :S], S + 4)
    got, _ = model.decode_step(tokens[:, S:], S, cache)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_init_cache_shapes():
    cfg = reduced_config("yi-34b", n_heads=8, n_kv_heads=2)
    cache = init_cache(cfg, 3, 20, device="cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0]["k"].shape == (3, 20, 2, cfg.d_head)
    assert cache[0]["v"].dtype == torch.bfloat16


def _reference_shapes(jcfg):
    """{reference keypath: shape} of ``jcfg``'s parameters, unallocated."""
    tree = jax.eval_shape(lambda: jinit_params(jcfg, 0))
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_port_names(ref_shapes):
    """The reference's stacked keypaths as the port's per-layer names."""
    out = {}
    for key, shape in ref_shapes.items():
        head, rest = key.split("/", 1)
        if head in ("groups", "enc_groups"):
            g, pos, path = rest.split("/", 2)
            assert (g, pos) == ("0", "pos0"), key    # one ("global",) group each
            stack = "layers" if head == "groups" else "enc_layers"
            out.update((f"{stack}.{i}.{path.replace('/', '.')}", shape[1:])
                       for i in range(shape[0]))
        else:
            out[key.replace("/", ".")] = shape
    return out


@pytest.mark.parametrize("width", ["full", "reduced"])
def test_unported_block_kind_raises(width):
    """whisper-large-v3's blocks build, the encoder stack, the decoders'
    cross-attention and the audio stub's frame_proj included, with every
    parameter of the reference at its shape (the published widths built
    on the meta device, as shapes only); a block kind no config holds is
    still refused."""
    cfg, jcfg = ((get_config, jget_config) if width == "full" else
                 (reduced_config, jreduced_config))
    cfg, jcfg = cfg("whisper-large-v3"), jcfg("whisper-large-v3")
    model = init_params(cfg, 0, "cpu") if width == "reduced" else \
        Model(cfg, device="meta")
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == _as_port_names(_reference_shapes(jcfg))
    assert len(model.enc_layers) == cfg.encoder_layers == (32 if width == "full" else 2)
    assert got["layers.0.cross.wk.w"] == (cfg.d_model, cfg.n_kv_heads * cfg.d_head)
    with pytest.raises(NotImplementedError, match="block kind 'bogus'"):
        Block(cfg, "bogus", "cpu")


@pytest.mark.parametrize("entry", ["init_params", "from_jax_params", "init_state",
                                   "init_cache", "Model"])
def test_entry_points_default_to_the_card(entry):
    """Without a ``device`` the model API's entry points run on the card
    and raise where there is none; they never fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced_config("yi-34b")
    calls = {"init_params": lambda: init_params(cfg, 0),
             "from_jax_params": lambda: from_jax_params(cfg, {}),
             "init_state": lambda: steps.init_state(cfg, adamw.AdamWConfig()),
             "init_cache": lambda: init_cache(cfg, 2, 8),
             "Model": lambda: Model(cfg)}
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


class _P:
    """Attribute bag standing in for a parameter module."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(kind):
    from repro.models.layers import apply_norm as jnorm
    from repro_torch.models.layers import apply_norm
    x, scale, bias = (np.random.default_rng(1).standard_normal(s).astype(np.float32)
                      for s in ((3, 5, 16), (16,), (16,)))
    want = jnorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 jnp.asarray(x).astype(jnp.bfloat16), kind)
    got = apply_norm(_P(scale=torch.from_numpy(scale), bias=torch.from_numpy(bias)),
                     torch.from_numpy(x).bfloat16(), kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["silu_glu", "gelu_glu", "sq_relu", "gelu"])
def test_act_matches(kind):
    from repro.models.layers import _act as jact
    from repro_torch.models.layers import _act
    x = np.random.default_rng(2).standard_normal((4, 32)).astype(np.float32) * 3
    np.testing.assert_allclose(_act(torch.from_numpy(x), kind).numpy(),
                               np.asarray(jact(jnp.asarray(x), kind)),
                               rtol=1e-5, atol=1e-5)


def test_linear_rope_embed_logits_match():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e6).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 5e6)),
        rtol=1e-5, atol=1e-5)
    w, b = rng.standard_normal((16, 8)).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    h = x.reshape(2, 24, 16)
    np.testing.assert_allclose(
        tl.apply_linear(_P(w=torch.from_numpy(w), b=torch.from_numpy(b)),
                        torch.from_numpy(h)).numpy(),
        np.asarray(jl.apply_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                   jnp.asarray(h))), rtol=1e-5, atol=1e-5)
    cfg = reduced_config("yi-34b", tie_embeddings=True, logit_softcap=3.0)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 5))
    t_emb = tl.apply_embed(_P(table=torch.from_numpy(table)), torch.from_numpy(toks), cfg)
    j_emb = jl.apply_embed({"table": jnp.asarray(table)}, jnp.asarray(toks), cfg)
    np.testing.assert_array_equal(_np(t_emb), _np(j_emb))
    t_lg = tl.apply_logits(None, _P(table=torch.from_numpy(table)), t_emb, cfg)
    j_lg = jl.apply_logits({}, {"table": jnp.asarray(table)}, j_emb, cfg)
    np.testing.assert_allclose(_np(t_lg), _np(j_lg), rtol=2e-2, atol=2e-2)
    assert float(t_lg.abs().max()) <= 3.0
