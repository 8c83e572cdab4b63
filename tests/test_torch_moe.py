"""The MoE block of the port (``models/moe.py``) against the JAX package's
(``repro/models/moe.py``), on the CPU.

``apply_moe`` alone, on the reduced mixtral-8x7b's first-layer weights
from the reference's ``init_params``, with inputs from a numpy seed:

- at the default ``capacity_factor`` 1.25, on inputs leaning towards
  expert 0 so that the test can assert that assignments are dropped, and
  at ``capacity_factor = n_experts``, where none is;
- in both, at fp32, the expert choices equal the reference's
  (``lax.top_k``) and the queue slots equal both the reference's rule
  (a cumsum over the token-major, k-minor assignments) and a plain loop;
  the outputs, and the gradients through the block, agree to 1e-5;
- at bf16 the router's top-k agrees for every token, or where a choice
  flips the reference's own margin between the k-th and the next logit is
  below one bf16 ulp (the two packages' bf16 matmuls may round one ulp
  apart); the outputs agree to rtol 5e-2, atol 1e-1.

Then the reduced mixtral-8x7b (``moe_local``, window 16 < the prompt) and
moonshot-v1-16b-a3b (``moe_global``, 64 experts top-6 reduced to 4 top-2,
one KV head per query head) through prefill and eight decode steps, at
fp32 and bf16, with ``tests/test_torch_families.py``'s check.
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import from_jax_params, init_params, moe  # noqa: E402
from repro_torch.models.params import load_named  # noqa: E402
from test_torch_families import check_prefill_and_decode, reference_params  # noqa: E402
from test_torch_model import flatten  # noqa: E402
from test_torch_rglru import _np  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

B, S = 2, 32
ARCH = "mixtral-8x7b"


def _configs(compute_dtype="float32", **kw):
    kw = dict(kw, compute_dtype=compute_dtype, param_dtype="float32")
    return jreduced_config(ARCH, **kw), reduced_config(ARCH, **kw)


@functools.lru_cache(maxsize=None)
def _first_layer():
    """The reference's first-layer MoE weights at fp32, by port name."""
    flat = flatten(jinit_params(_configs()[0], 0))
    pre = "groups/0/pos0/moe/"
    return {k[len(pre):].replace("/", "."): v[0] for k, v in flat.items()
            if k.startswith(pre)}


def _block(cfg):
    """The reference's first-layer MoE weights (a dict of jnp arrays) and a
    port ``MoE`` holding the same numbers."""
    named = _first_layer()
    jp = {"router": {"w": jnp.asarray(named["router.w"])}}
    jp.update({name: jnp.asarray(named[name]) for name in ("wi", "wg", "wo")})
    tp = moe.MoE(cfg)
    load_named(dict(tp.named_parameters()),
               {name: torch.tensor(a) for name, a in named.items()})
    return jp, tp


def _x(jp, seed=3, lean=3.0):
    """Tokens leaning towards expert 0 (``lean`` x the unit vector of its
    router column): expert 0 is oversubscribed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    w0 = np.asarray(jp["router"]["w"])[:, 0]
    return x + lean * w0 / np.linalg.norm(w0)


def _loop_slots(topi, E):
    """Queue slot of each assignment, token-major and k-minor, by a loop."""
    Bn, Sn, k = topi.shape
    out = np.zeros((Bn, Sn * k), np.int64)
    for b in range(Bn):
        seen = np.zeros(E, np.int64)
        for i, e in enumerate(topi[b].reshape(-1)):
            out[b, i] = seen[e]
            seen[e] += 1
    return out


def _reference_slots(topi, E):
    """The reference's slot rule, as ``repro/models/moe.py`` computes it."""
    flat_e = topi.reshape(topi.shape[0], -1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    return np.asarray(jnp.max(jnp.cumsum(onehot, axis=1) * onehot - 1, axis=-1))


def test_capacity_matches_reference():
    for cf in (1.0, 1.25, 2.0, 4.0):
        jcfg, cfg = _configs(capacity_factor=cf)
        for seq in (1, 7, 32, 8192):
            assert moe.capacity(cfg, seq) == jmoe.capacity(jcfg, seq)
    _, cfg = _configs()
    assert moe.capacity(dataclasses.replace(cfg, n_experts=8, top_k=2), 8192) == 2560


def test_route_breaks_ties_to_the_lower_expert():
    """Experts 1 and 2 with the same router column tie on every token: the
    reference's ``lax.top_k`` and the port's route pick the lower one."""
    jcfg, cfg = _configs()
    jp, tp = _block(cfg)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    with torch.no_grad():
        tp.router.w.copy_(torch.from_numpy(w))
    x = np.random.default_rng(4).standard_normal((B, S, 64)).astype(np.float32)
    jw, ji = jmoe.route(jp, jnp.asarray(x), jcfg)
    tw, ti = moe.route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert (ti == 2).sum() < (ti == 1).sum()


@pytest.mark.parametrize("cf,drops", [(1.25, True), (4.0, False)],
                         ids=["default-cf-drops", "cf-n_experts-no-drop"])
def test_apply_moe_matches_reference(cf, drops):
    jcfg, cfg = _configs(capacity_factor=cf)
    jp, tp = _block(cfg)
    x = _x(jp)
    E, C = cfg.n_experts, moe.capacity(cfg, S)

    jw, ji = jmoe.route(jp, jnp.asarray(x), jcfg)
    tw, ti = moe.route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    slot, keep = moe.dispatch(ti, C, E)
    np.testing.assert_array_equal(slot.numpy(), _reference_slots(np.asarray(ji), E))
    np.testing.assert_array_equal(slot.numpy(), _loop_slots(ti.numpy(), E))
    n_dropped = int((~keep).sum())
    assert (n_dropped > 0) == drops, n_dropped

    want = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    got = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_apply_moe_gradients_match_reference():
    """Gradients of a weighted sum of the block's output with respect to x
    and every weight, in the dropping case, against ``jax.grad``."""
    jcfg, cfg = _configs()
    jp, tp = _block(cfg)
    x = _x(jp)
    ct = np.random.default_rng(5).standard_normal((B, S, 64)).astype(np.float32)

    def jf(p, x):
        return jnp.sum(jmoe.apply_moe(p, x, jcfg) * ct)

    jg_p, jg_x = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    params = dict(tp.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    out = (moe.apply_moe(tp, tx, cfg) * torch.from_numpy(ct)).sum()
    grads = torch.autograd.grad(out, [tx, *params.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_x), rtol=1e-5, atol=1e-5)
    want = {"router.w": jg_p["router"]["w"], "wi": jg_p["wi"], "wg": jg_p["wg"],
            "wo": jg_p["wo"]}
    for name, g in zip(params, grads[1:]):
        ref = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=name)


def _bf16_ulp(v):
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def test_apply_moe_bf16_routes_agree():
    """At bf16 the router's top-k equals the reference's for every token;
    a flip is allowed only where the reference's own k-th and next logits
    lie within one bf16 ulp.  The outputs are compared on every batch row
    that holds no flipped token (dispatch is per row, so a flip moves the
    queues of its own row only), and at least one row is compared."""
    jcfg, cfg = _configs("bfloat16")
    jp, tp = _block(cfg)
    x = _x(jp, seed=6, lean=1.0)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    _, ji = jmoe.route(jp, jx, jcfg)
    _, ti = moe.route(tp, tx, cfg)
    ji = np.asarray(ji)
    flipped = np.argwhere((np.sort(ti.numpy(), -1) != np.sort(ji, -1)).any(-1))
    if len(flipped):
        logits = np.asarray(jnp.einsum("bsd,de->bse", jx,
                                       jp["router"]["w"].astype(jnp.bfloat16))
                            .astype(jnp.float32))
        k = cfg.top_k
        for b, s in flipped:
            srt = np.sort(logits[b, s])[::-1]
            margin = srt[k - 1] - srt[k]
            assert margin <= _bf16_ulp(srt[k - 1]), (b, s, margin)
    rows = sorted(set(range(B)) - {int(b) for b, _ in flipped})
    assert rows, "every batch row holds a flipped route"
    want = jmoe.apply_moe(jp, jx, jcfg)
    got = moe.apply_moe(tp, tx, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got)[rows], _np(want)[rows], rtol=5e-2, atol=1e-1)


def test_moe_params_carry_across():
    """The reference's ``moe/router/w``, ``moe/wi``, ``moe/wg``, ``moe/wo``
    land in ``layers.<i>.moe.router.w``, ``moe.wi``, ... one to one, with
    the experts' (E, d, f) / (E, f, d) shapes."""
    cfg = reduced_config(ARCH)
    flat = flatten(reference_params(ARCH))
    model = from_jax_params(cfg, flat, device="cpu")
    sd = model.state_dict()
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert sd["layers.1.moe.wi"].shape == (E, d, f) and sd["layers.1.moe.wo"].shape == (E, f, d)
    assert sd["layers.1.moe.wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["layers.1.moe.wg"].float().numpy(),
                                  flat["groups/0/pos0/moe/wg"][1].astype(np.float32))
    assert not any(".mlp." in n for n in sd)
    stacked = sum(k.startswith("groups/") for k in flat)     # one group of all layers
    assert len(sd) == len(flat) - stacked + cfg.n_layers * stacked
    with pytest.raises(KeyError):
        from_jax_params(cfg, {k: v for k, v in flat.items() if not k.endswith("moe/wg")},
                        device="cpu")


def test_init_params_draws_the_experts():
    cfg = reduced_config(ARCH, param_dtype="float32")
    m = init_params(cfg, 0, "cpu").layers[0].moe
    assert abs(float(m.wi.std()) - 1 / np.sqrt(cfg.d_model)) < 0.02
    assert abs(float(m.wo.std()) - 1 / np.sqrt(cfg.d_ff)) < 0.02
    assert not torch.equal(m.wi[0], m.wi[1])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_prefill_and_decode_match_reference(arch, compute_dtype):
    check_prefill_and_decode(arch, compute_dtype)
