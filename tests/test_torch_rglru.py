"""RG-LRU (recurrentgemma) of the port against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages.  The scan op
(``kernels.ops.rglru_scan``, whose CPU path is the plain sequential
``rglru_scan_ref``) is held against the Pallas kernel in interpret mode at
1e-5; the recurrent block against the reference (associative scan) at
2e-4, the tolerance of ``tests/test_kernels.py`` for that scan; the local
attention at recurrentgemma's head shape (d_head 256, 16 query heads on one
KV head, a window) against the Pallas kernel; and the reduced
recurrentgemma-9b through prefill and eight decode steps, with a prompt
longer than its window (the ring buffer wraps) and a leftover layer group.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import from_jax_params, init_params, layers, rglru  # noqa: E402
from repro_torch.models.transformer import (PLAIN, group_meta,  # noqa: E402
                                            layer_cache_shape)
from test_torch_model import flatten  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=1e-1)}
B, S, STEPS = 2, 24, 8          # S > the reduced window (16): the ring wraps
N_LAYERS = 8                    # 2 x (rec, rec, local) + a leftover (rec, rec)



def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ab(seed, B_, S_, W):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.99, (B_, S_, W)).astype(np.float32)
    b = rng.standard_normal((B_, S_, W)).astype(np.float32)
    h0 = rng.standard_normal((B_, W)).astype(np.float32)
    return a, b, h0


# ---------------------------------------------------------------------------
# K2's op and plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B_,S_,W", [(2, 64, 128), (4, 128, 64), (1, 1, 32)])
def test_ops_rglru_scan_matches_pallas_interpret(B_, S_, W, with_h0):
    a, b, h0 = _ab(1, B_, S_, W)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    want = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, interpret=True)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), th0)
    assert got.dtype == torch.float32 and got.shape == (B_, S_, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S_", [64, 1024])
def test_associative_scan_matches_reference(S_, with_h0):
    """The model's plain log-depth scan against the reference's (which scans
    512-step chunks at S = 1024) at the associative-scan tolerance."""
    a, b, h0 = _ab(2, 2, S_, 32)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0)
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), th0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_ops_rglru_scan_rejects_other_devices():
    a = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no rglru_scan kernel"):
        ops.rglru_scan(a, a)


# ---------------------------------------------------------------------------
# The recurrent block
# ---------------------------------------------------------------------------

def _configs(compute_dtype="float32", **kw):
    kw = dict(n_layers=N_LAYERS, compute_dtype=compute_dtype, **kw)
    return (jreduced_config("recurrentgemma-9b", **kw),
            reduced_config("recurrentgemma-9b", **kw))


def _rec_block(compute_dtype="float32"):
    jcfg, cfg = _configs(compute_dtype)
    params = jinit_params(jcfg, 0)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["groups"][0]["pos0"]["rec"])
    model = from_jax_params(cfg, flatten(params), device="cpu")
    return jcfg, cfg, jp, model.layers[0].rec


def _x(seed, cfg, S_):
    x = np.random.default_rng(seed).standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _state(seed, cfg):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, cfg.rnn_width)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.conv_width - 1, cfg.rnn_width)).astype(np.float32)
    return ({"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
            {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)})


@pytest.mark.parametrize("scan", ["ops", "plain"])
@pytest.mark.parametrize("S_,with_state", [(20, False), (20, True), (1, True)],
                         ids=["prefill", "prefill-from-state", "decode"])
def test_apply_rglru_matches_reference(S_, with_state, scan):
    jcfg, cfg, jp, tp = _rec_block()
    jx, tx = _x(3, cfg, S_)
    jst, tst = _state(4, cfg) if with_state else (None, None)
    jout, jnew = jrglru.apply_rglru(jp, jx, jcfg, state=jst, return_state=True)
    fn = ops.rglru_scan if scan == "ops" else PLAIN.rglru_scan
    tout, tnew = rglru.apply_rglru(tp, tx, cfg, state=tst, return_state=True, scan=fn)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    np.testing.assert_allclose(_np(tnew["h"]), _np(jnew["h"]), **tol)
    np.testing.assert_allclose(_np(tnew["conv"]), _np(jnew["conv"]), rtol=0, atol=0)


def test_gates_and_conv_match_reference():
    jcfg, cfg, jp, tp = _rec_block()
    jx, tx = _x(5, cfg, 9)
    xs = np.random.default_rng(6).standard_normal((B, 9, cfg.rnn_width)).astype(np.float32)
    np.testing.assert_allclose(
        rglru.causal_conv1d(tp, torch.from_numpy(xs)).numpy(),
        np.asarray(jrglru.causal_conv1d(jp, jnp.asarray(xs))), rtol=1e-5, atol=1e-5)
    (ja, jg), (ta, tg) = jrglru._gates(jp, jnp.asarray(xs)), rglru._gates(tp, torch.from_numpy(xs))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Local attention at recurrentgemma's head shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_attention_dh256_matches_pallas_interpret(dtype):
    """16 query heads on one KV head of 256, window 48 < S: the shape the
    card's kernel takes on recurrentgemma's local layers."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 128, 16, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, 128, 1, 256)).astype(np.float32) for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                          causal=True, window=48, interpret=True)
    got = ops.attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                        causal=True, window=48)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("pos", [3, 16, 37])
def test_windowed_attention_decode_matches_reference(pos):
    """One decode step against a ring buffer of the window's size: the slot
    is pos % window and every slot is valid once the ring is full."""
    jcfg, cfg = _configs()
    params = jinit_params(jcfg, 0)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["groups"][0]["pos2"]["attn"])
    tp = from_jax_params(cfg, flatten(params), device="cpu").layers[2].attn
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, cfg.window, 1, cfg.d_head)).astype(np.float32)
              for _ in range(2))
    jy, jc = jlayers.attention_decode(jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                      jcfg, pos=jnp.asarray(pos, jnp.int32), window=cfg.window)
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    ty, tc = layers.attention_decode(tp, torch.from_numpy(x), tcache, cfg, pos=pos,
                                     window=cfg.window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def test_configs_mirror_reference():
    assert dataclasses.asdict(get_config("recurrentgemma-9b")) == \
        dataclasses.asdict(jget_config("recurrentgemma-9b"))
    for kw in ({}, dict(n_layers=N_LAYERS)):
        assert dataclasses.asdict(reduced_config("recurrentgemma-9b", **kw)) == \
            dataclasses.asdict(jreduced_config("recurrentgemma-9b", **kw))


def test_cache_shapes():
    cfg = get_config("recurrentgemma-9b")
    assert layer_cache_shape(cfg, "local", 2, 4144) == {
        "k": ((2, 2048, 1, 256), torch.bfloat16), "v": ((2, 2048, 1, 256), torch.bfloat16)}
    assert layer_cache_shape(cfg, "local", 2, 100)["k"][0] == (2, 100, 1, 256)
    assert layer_cache_shape(cfg, "rec", 2, 4144) == {
        "h": ((2, 4096), torch.float32), "conv": ((2, 3, 4096), torch.float32)}
    assert cfg.layer_kinds.count("rec") == 26 and cfg.layer_kinds.count("local") == 12


def _ref_caches(j_cache, cfg):
    """The reference's grouped cache as one dict per layer, in layer order."""
    out = []
    for g, (unit, n) in enumerate(group_meta(cfg)):
        for rep in range(n):
            for i in range(len(unit)):
                out.append({name: a[rep] for name, a in j_cache["groups"][g][f"pos{i}"].items()})
    return out


def _close_caches(t_cache, j_cache, cfg, tol):
    want = _ref_caches(j_cache, cfg)
    assert len(want) == len(t_cache) == cfg.n_layers
    for layer, ref_layer in zip(t_cache, want):
        assert sorted(layer) == sorted(ref_layer)
        for name in layer:
            assert tuple(layer[name].shape) == tuple(ref_layer[name].shape)
            np.testing.assert_allclose(_np(layer[name]), _np(ref_layer[name]), **tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(compute_dtype):
    jcfg, cfg = _configs(compute_dtype)
    assert [len(u) for u, _ in group_meta(cfg)] == [3, 2]   # leftover group
    params = jinit_params(jcfg, 0)
    model = from_jax_params(cfg, flatten(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    s_buf = S + STEPS
    tol = TOL[compute_dtype]

    j_logits, j_cache = jprefill(params, jcfg, jnp.asarray(tokens, jnp.int32), s_buf)
    t_logits, t_cache = model.prefill(torch.from_numpy(tokens), s_buf)
    assert t_logits.shape == (B, 1, cfg.vocab_size)
    _close_caches(t_cache, j_cache, cfg, tol)
    ltol = tol
    if compute_dtype == "bfloat16":
        # The tied embedding (init scale 1) gives logits of rms ~8 where
        # yi-34b's untied ones have rms ~1, so a one-ulp bf16 difference in
        # the final hidden state (the two packages' matmuls sum in different
        # orders) moves a logit ~8x as far: the absolute part of the
        # tolerance is taken relative to the logits' rms.
        ltol = dict(tol, atol=tol["atol"] * max(1.0, float(np.sqrt(np.mean(_np(j_logits) ** 2)))))
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **ltol)

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
        np.testing.assert_allclose(_np(t_logits), _np(j_logits), **ltol)
        j_tok = jnp.argmax(j_logits, axis=-1).astype(jnp.int32)
        t_tok = t_logits.argmax(-1)
    _close_caches(t_cache, j_cache, cfg, tol)


def test_plain_kernels_match_serving_path():
    """Prefill through the models' plain forms (``PLAIN``: jnp-style mha,
    associative scan) equals prefill through ``kernels.ops`` (float32)."""
    _, cfg = _configs("float32")
    model = init_params(cfg, 2, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S)))
    want, want_cache = model.prefill(tokens, S + 4)
    got, got_cache = model.prefill(tokens, S + 4, kernels=PLAIN)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_cache, want_cache):
        for name in a:
            torch.testing.assert_close(a[name], b[name], rtol=1e-4, atol=1e-4)


def test_prefill_then_decode_matches_longer_prefill():
    """Decoding token S after a prefill of S tokens gives the logits of a
    prefill of S + 1 tokens (the port against itself, float32), with the
    window's ring buffer already wrapped."""
    _, cfg = _configs("float32")
    model = init_params(cfg, 1, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)))
    want, _ = model.prefill(tokens, S + 1)
    _, cache = model.prefill(tokens[:, :S], S + 4)
    got, _ = model.decode_step(tokens[:, S:], S, cache)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
