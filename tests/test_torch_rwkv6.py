"""RWKV-6 of the port against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages.  The WKV6 op
(``kernels.ops.wkv6``, whose CPU path is the plain ``wkv6_ref``) is held
against the Pallas kernel in interpret mode at the JAX package's own
kernel tolerance (5e-4) and against the JAX oracle's final state at 1e-5;
the time-mix against the reference's sequential form in float32 (1e-4) and
its default chunked form at bf16 level (3e-2: the chunked form streams
r/k/v in bf16, ``repro/models/rwkv6.py:114``); the reduced rwkv6-3b through
prefill and eight decode steps as ``test_torch_model.py`` does for yi-34b.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro.models.model import _sin_at as j_sin_at  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv6 as k3  # noqa: E402
from repro_torch.models import from_jax_params, init_params, layers, rwkv6  # noqa: E402
from repro_torch.models.model import _sin_at  # noqa: E402
from repro_torch.models.transformer import init_cache, layer_cache_shape  # noqa: E402
from test_torch_model import flatten  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=1e-1)}
B, S, STEPS = 2, 12, 8



def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _wkv_inputs(seed, B, T, H, dh, scale=0.5):
    """r, k, v, logw, u as the JAX package's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    r, k, v, lw = (scale * rng.standard_normal((B, T, H, dh)).astype(np.float32)
                   for _ in range(4))
    logw = -np.exp(np.clip(lw, -3, 0.5)).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, dh))).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K3's op and plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B_,T,H,dh", [(1, 64, 2, 32), (2, 128, 4, 64)])
def test_ops_wkv6_matches_pallas_interpret(B_, T, H, dh):
    arrays = _wkv_inputs(1, B_, T, H, dh)
    want = jops.wkv6(*_j(*arrays), interpret=True)
    y, s_final = ops.wkv6(*_t(*arrays))
    assert y.shape == (B_, T, H, dh) and s_final.shape == (B_, H, dh, dh)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_ref_matches_jax_ref(dtype):
    """Merged-head oracle: y and the final state (which the Pallas kernel's
    wrapper drops) against the JAX oracle, from a nonzero initial state."""
    BH, T, dh = 3, 40, 32
    rng = np.random.default_rng(2)
    r, k, v, lw = (0.5 * rng.standard_normal((BH, T, dh)).astype(np.float32)
                   for _ in range(4))
    logw = -np.exp(np.clip(lw, -3, 0.5)).astype(np.float32)
    u = (0.3 * rng.standard_normal((BH, dh))).astype(np.float32)
    s0 = rng.standard_normal((BH, dh, dh)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, js = jref.wkv6_ref(*(jnp.asarray(a).astype(jd) for a in (r, k, v)),
                           *_j(logw, u), s0=jnp.asarray(s0))
    ty, ts = ref.wkv6_ref(*(torch.from_numpy(a).to(td) for a in (r, k, v)),
                          *_t(logw, u), s0=torch.from_numpy(s0))
    assert ty.dtype == td and ts.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_wkv6_final_state_matches_jax_ref():
    B_, T, H, dh = 2, 48, 3, 64
    arrays = _wkv_inputs(3, B_, T, H, dh)
    r, k, v, logw, u = arrays

    def merge(a):
        return a.transpose(0, 2, 1, 3).reshape(B_ * H, T, dh)

    jy, js = jref.wkv6_ref(*_j(merge(r), merge(k), merge(v), merge(logw)),
                           jnp.asarray(np.broadcast_to(u[None], (B_, H, dh)).reshape(B_ * H, dh)))
    y, s_final = ops.wkv6(*_t(*arrays))
    np.testing.assert_allclose(s_final.reshape(B_ * H, dh, dh).numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.transpose(1, 2).reshape(B_ * H, T, dh).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_wkv6_state_threading():
    """Splitting a sequence in two with the state carried == one pass (the
    decode cache relies on it), and both == the JAX oracle."""
    B_, T, H, dh = 1, 64, 1, 32
    r, k, v, logw, _ = _wkv_inputs(4, B_, T, H, dh, scale=0.4)
    u = np.zeros((H, dh), np.float32)
    full, s_full = ops.wkv6(*_t(r, k, v, logw, u))
    half = T // 2
    y1, s1 = ops.wkv6(*_t(*(a[:, :half] for a in (r, k, v, logw)), u))
    y2, s2 = ops.wkv6(*_t(*(a[:, half:] for a in (r, k, v, logw)), u), s0=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)
    want, _ = jref.wkv6_ref(*_j(*(a.reshape(B_ * H, T, dh) for a in (r, k, v, logw))),
                            jnp.zeros((B_ * H, dh)))
    np.testing.assert_allclose(full.reshape(B_ * H, T, dh).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_value_columns_are_independent(dh, dtype, with_s0):
    """The invariant K3's value split rests on: the plain version run on one
    block of value columns of v (and of s0), as one CTA of the kernel runs,
    gives that block of y and of s_final, bit for bit."""
    B_, T, H = 2, 37, 3
    r, k, v, logw, u = _wkv_inputs(5, B_, T, H, dh)
    s0 = np.random.default_rng(6).standard_normal((B_, H, dh, dh)).astype(np.float32)
    td = getattr(torch, dtype)
    r, k, v = (torch.from_numpy(a).to(td) for a in (r, k, v))
    logw, u, s0 = _t(logw, u, s0)
    s0 = s0 if with_s0 else None
    y, s_final = ops.wkv6_ref(r, k, v, logw, u, s0)
    ev = k3.VALUE_COLUMNS_PER_CTA
    assert dh % ev == 0
    for e0 in range(0, dh, ev):
        cols = slice(e0, e0 + ev)
        yb, sb = ops.wkv6_ref(r, k, v[..., cols], logw, u,
                              None if s0 is None else s0[..., cols])
        assert torch.equal(yb, y[..., cols])
        assert torch.equal(sb, s_final[..., cols])


def test_ops_wkv6_rejects_other_devices():
    r = torch.zeros((1, 2, 1, 32), device="meta")
    with pytest.raises(ValueError, match="no wkv6 kernel"):
        ops.wkv6(r, r, r, r, torch.zeros((1, 32), device="meta"))


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_forms_match_reference(with_state):
    """The model's sequential and chunked plain forms against the JAX
    package's (the chunked one at a ragged length, so the padding runs)."""
    B_, T, H, dh = 2, 50, 2, 32
    arrays = _wkv_inputs(5, B_, T, H, dh)
    s0 = (np.random.default_rng(6).standard_normal((B_, H, dh, dh)).astype(np.float32)
          if with_state else None)
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    jy, js = jrwkv6.wkv6_sequential(*_j(*arrays), js0)
    ty, ts = rwkv6.wkv6_sequential(*_t(*arrays), ts0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    jy, js = jrwkv6.wkv6_chunked(*_j(*arrays), js0, chunk=16)
    ty, ts = rwkv6.wkv6_chunked(*_t(*arrays), ts0, chunk=16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

def _block(compute_dtype="float32"):
    """The reference's first-layer rwkv parameters of the reduced config and
    the port's ``TimeMix`` holding the same numbers."""
    jcfg = jreduced_config("rwkv6-3b", compute_dtype=compute_dtype)
    cfg = reduced_config("rwkv6-3b", compute_dtype=compute_dtype)
    params = jinit_params(jcfg, 0)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["groups"][0]["pos0"]["tm"])
    model = from_jax_params(cfg, flatten(params), device="cpu")
    return jcfg, cfg, jp, model.layers[0].tm


def _x(seed, cfg, S_, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _state(seed, cfg):
    rng = np.random.default_rng(seed)
    dh = rwkv6.rwkv6_head_dim(cfg)
    shift = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    wkv = (0.3 * rng.standard_normal((B, cfg.d_model // dh, dh, dh))).astype(np.float32)
    return ({"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)},
            {"shift": torch.from_numpy(shift), "wkv": torch.from_numpy(wkv)})


@pytest.mark.parametrize("S_,with_state", [(16, False), (16, True), (1, True)],
                         ids=["prefill", "prefill-from-state", "decode"])
def test_time_mix_matches_sequential_reference(S_, with_state):
    jcfg, cfg, jp, tp = _block()
    jx, tx = _x(7, cfg, S_)
    jst, tst = _state(8, cfg) if with_state else (None, None)
    jout, jnew = jrwkv6.apply_time_mix(jp, jx, jcfg, state=jst, return_state=True,
                                       use_chunked=False)
    tout, tnew = rwkv6.apply_time_mix(tp, tx, cfg, state=tst, return_state=True)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    np.testing.assert_allclose(_np(tnew["wkv"]), _np(jnew["wkv"]), **tol)
    np.testing.assert_allclose(_np(tnew["shift"]), _np(jnew["shift"]), rtol=0, atol=0)


@pytest.mark.parametrize("S_", [40, 128])
def test_time_mix_matches_chunked_reference(S_):
    """The reference's default prefill (chunked, r/k/v streamed in bf16) in
    the serving path's bf16, where both packages see the same bf16 r/k/v;
    in float32 the port is held to the sequential form above instead."""
    jcfg, cfg, jp, tp = _block("bfloat16")
    jx, tx = _x(9, cfg, S_, "bfloat16")
    jout = jrwkv6.apply_time_mix(jp, jx, jcfg)
    tout = rwkv6.apply_time_mix(tp, tx, cfg)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(with_state):
    jcfg, cfg, jp, tp = _block()
    jx, tx = _x(10, cfg, 6)
    jst, tst = _state(11, cfg) if with_state else (None, None)
    jout, jnew = jrwkv6.apply_channel_mix(jp, jx, jcfg, state=jst, return_state=True)
    tout, tnew = rwkv6.apply_channel_mix(tp, tx, cfg, state=tst, return_state=True)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tnew["shift"]), _np(jnew["shift"]), rtol=0, atol=0)


def test_group_norm_matches_reference():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    want = jrwkv6._group_norm(jnp.asarray(x), jnp.asarray(scale), 4)
    got = rwkv6._group_norm(torch.from_numpy(x), torch.from_numpy(scale), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sinusoidal_positions_match_reference():
    """Both packages form the same fp32 angles; sin/cos of an angle near
    2e3 rad differ by the libraries' range reduction, up to about
    |angle| * 2^-24 = 1.2e-4, hence the absolute tolerance there."""
    for seq, d, off, atol in ((7, 64, 0, 1e-6), (1, 10, 5, 1e-6), (3, 2560, 2040, 2e-4)):
        np.testing.assert_allclose(layers.sinusoidal(seq, d, off).numpy(),
                                   np.asarray(jlayers.sinusoidal(seq, d, off)),
                                   rtol=0, atol=atol)
    np.testing.assert_allclose(_sin_at(13, 64, "cpu").numpy(),
                               np.asarray(j_sin_at(jnp.asarray(13, jnp.int32), 64)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_sin_at(2047, 2560, "cpu").numpy(),
                               np.asarray(j_sin_at(jnp.asarray(2047, jnp.int32), 2560)),
                               rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def test_configs_mirror_reference():
    assert dataclasses.asdict(get_config("rwkv6-3b")) == \
        dataclasses.asdict(jget_config("rwkv6-3b"))
    cfg = reduced_config("rwkv6-3b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jreduced_config("rwkv6-3b"))
    assert (cfg.n_heads, cfg.d_model, cfg.d_head) == (1, 64, 64)


def test_cache_shapes():
    cfg = reduced_config("rwkv6-3b")
    assert layer_cache_shape(cfg, "rwkv", 3, 20) == {
        "tm_shift": ((3, 64), torch.float32), "wkv": ((3, 1, 64, 64), torch.float32),
        "cm_shift": ((3, 64), torch.float32)}
    full = get_config("rwkv6-3b")
    assert layer_cache_shape(full, "rwkv", 4, 2096)["wkv"] == ((4, 40, 64, 64), torch.float32)
    assert len(init_cache(cfg, 3, 20, device="cpu")) == cfg.n_layers


def _ref_cache(j_cache, layer):
    return {name: a[layer] for name, a in j_cache["groups"][0]["pos0"].items()}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(compute_dtype, monkeypatch):
    kw = dict(compute_dtype=compute_dtype)
    jcfg, cfg = jreduced_config("rwkv6-3b", **kw), reduced_config("rwkv6-3b", **kw)
    if compute_dtype == "float32":
        # the reference's chunked prefill streams r/k/v in bf16; in float32
        # the port is held to its exact sequential form (its decode form)
        monkeypatch.setattr(jrwkv6, "wkv6_chunked", jrwkv6.wkv6_sequential)
    params = jinit_params(jcfg, 0)
    model = from_jax_params(cfg, flatten(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    s_buf = S + STEPS
    tol = TOL[compute_dtype]

    j_logits, j_cache = jprefill(params, jcfg, jnp.asarray(tokens, jnp.int32), s_buf)
    t_logits, t_cache = model.prefill(torch.from_numpy(tokens), s_buf)
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **tol)
    for i, layer in enumerate(t_cache):
        want = _ref_cache(j_cache, i)
        assert sorted(layer) == sorted(want)
        for name in layer:
            np.testing.assert_allclose(_np(layer[name]), _np(want[name]), **tol)

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
    for i, layer in enumerate(t_cache):
        for name, a in _ref_cache(j_cache, i).items():
            np.testing.assert_allclose(_np(layer[name]), _np(a), **tol)


def test_prefill_then_decode_matches_longer_prefill():
    """Decoding token S after a prefill of S tokens gives the logits of a
    prefill of S + 1 tokens (the port against itself, float32): the
    recurrent state and the sinusoidal position carry across."""
    cfg = reduced_config("rwkv6-3b", compute_dtype="float32")
    model = init_params(cfg, 1, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)))
    want, _ = model.prefill(tokens, S + 1)
    _, cache = model.prefill(tokens[:, :S], S + 4)
    got, _ = model.decode_step(tokens[:, S:], S, cache)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
