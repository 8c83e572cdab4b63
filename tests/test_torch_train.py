"""The port's training path against the JAX package's on the CPU.

Parameters come from the reference's ``init_params`` and are carried
across by checkpoint keypath (``from_jax_params``); tokens are drawn from a
numpy seed.  ``loss_fn`` and every gradient are held against
``jax.value_and_grad(repro.models.model.loss_fn)`` on the reduced yi-34b,
rwkv6-3b, recurrentgemma-9b, mixtral-8x7b (MoE with drops, window) and
gemma2-27b (sandwich norms, softcaps), all with fp32 parameters (the
reduced mixtral's are bf16; ``to_jax_params`` carries bf16 as numpy ``V2``,
the reference's bits, which ``test_bf16_parameters_refuse_numpy`` holds):
at fp32 compute the loss to rtol 1e-5 and
the gradients to rtol 1e-4 with atol 1e-6 * max|g_ref|; at bf16 compute
both to 2e-2 (the kernel tests' bf16 tolerance, the atol scaled by
max|g_ref|).

rwkv6-3b is the exception, and not a fault of the port: the reference's
``wkv6_chunked`` streams r, k and v through bfloat16 at any compute dtype
but float64 (``repro/models/rwkv6.py``), so their cotangents are rounded to
bfloat16 too.  An fp32 value that differs in its last bit between the two
packages' matmuls rounds to a bfloat16 neighbour one time in ~10^4, which
moves a whole column of the weight gradients by ~2^-9.  Its fp32 gradients
are therefore held at the bfloat16 tolerance (2e-2 * max|g_ref|; measured:
4.3e-3), its loss at fp32's 1e-5.  At bf16 compute its gradients lie up to
0.17 * max|g_ref| from the reference's own fp32 gradients, and the port's
within 0.1 * max|g_ref| of the reference's bf16 ones (measured: 0.091), so
that is their entries' bound.

Every leaf of every arch is also held as a whole, in relative 2-norm
||g - g_ref|| / ||g_ref||: at fp32 to 1e-5 (measured: 5.2e-7 at most) and
rwkv6-3b's to 2e-3 (measured: 3.6e-4); at bf16 to 5e-2 (measured: 2.1e-2
on rwkv6-3b, 1.4e-2 on recurrentgemma-9b, 7.7e-3 on yi-34b).  A leaf that
is zeroed gives 1.

pixtral-12b's loss and gradients are held with and without "patches"
(without them ``patch_proj`` gets zeros, as from ``jax.grad``), and a
parameter the forward does not reach otherwise makes the gradient raise.

Also here: gradients with remat on and off are equal bit for bit (one
group per layer, and nine layers, the reference's two-level sqrt split);
the chunked loss over several chunks, and at the default chunk length on
both sides of one chunk (one chunk is not checkpointed); ``mha``'s
per-chunk checkpoint;
``to_jax_params`` inverts ``from_jax_params`` for all ten architectures;
ten ``make_train_step``
steps (microbatches 1 and 2) track the reference's losses to 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.model as jmodel  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.data.pipeline import SyntheticTokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.layers import mha as jmha  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
import repro_torch.models.model as tmodel  # noqa: E402
from repro_torch.configs import list_archs, reduced_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.models.layers import mha  # noqa: E402
from repro_torch.models.params import to_jax_layout, to_jax_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)
from test_torch_model import flatten  # noqa: E402

ARCHS = ["yi-34b", "rwkv6-3b", "recurrentgemma-9b", "mixtral-8x7b", "gemma2-27b"]
B, S = 2, 16
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (rtol, atol / max|g_ref|, limit of |g - g_ref| / |g_ref| over each leaf)
GRAD_TOL = {"float32": (1e-4, 1e-6, 1e-5), "bfloat16": (2e-2, 2e-2, 5e-2)}
RWKV_GRAD_TOL = {"float32": (1e-4, 2e-2, 2e-3), "bfloat16": (2e-2, 1e-1, 5e-2)}


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def _reference(jcfg, batch, seed=0):
    params = jinit_params(jcfg, seed)
    fn = jax.jit(jax.value_and_grad(jmodel.loss_fn), static_argnums=1)
    loss, grads = fn(params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return params, float(loss), flatten(grads)


def _port_grads(model, batch, remat=True):
    loss, grads = steps.value_and_grad(model, _tbatch(batch), remat=remat)
    return float(loss), grads


def _check_grads(got, want, rtol, atol_rel, norm_rel):
    """Each entry within rtol and atol_rel * max|g_ref| of its leaf, and each
    leaf as a whole within norm_rel in relative 2-norm, so that a leaf
    wrong across most of its small entries fails too."""
    for key, ref in want.items():
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got[key], ref, rtol=rtol,
                                   atol=atol_rel * float(np.abs(ref).max()),
                                   err_msg=key)
        diff = np.asarray(got[key], np.float64) - ref
        gap = np.linalg.norm(diff) / np.linalg.norm(ref.astype(np.float64))
        assert gap <= norm_rel, f"{key}: relative norm gap {gap:.3e} > {norm_rel}"


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, compute_dtype):
    kw = dict(compute_dtype=compute_dtype, param_dtype="float32")
    jcfg, cfg = jreduced_config(arch, **kw), reduced_config(arch, **kw)
    batch = _batch(cfg.vocab_size)
    jparams, jloss, jgrads = _reference(jcfg, batch)
    model = from_jax_params(cfg, flatten(jparams), device="cpu")
    loss, grads = _port_grads(model, batch)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL[compute_dtype])
    got = to_jax_layout(cfg, {n: g.float() for n, g in grads.items()})
    assert set(got) == set(jgrads)
    tol = (RWKV_GRAD_TOL if arch == "rwkv6-3b" else GRAD_TOL)[compute_dtype]
    _check_grads(got, jgrads, *tol)


def test_pixtral_loss_with_patches_matches_reference():
    """A batch with "patches" (the vision stub's embeddings) gives the
    reference's loss and gradients, ``patch_proj``'s included (fp32)."""
    jcfg = jreduced_config("pixtral-12b", compute_dtype="float32")
    cfg = reduced_config("pixtral-12b", compute_dtype="float32")
    batch = _batch(cfg.vocab_size, seed=8)
    batch["patches"] = np.random.default_rng(9).standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    jparams, jloss, jgrads = _reference(jcfg, batch)
    model = from_jax_params(cfg, flatten(jparams), device="cpu")
    tb = {k: torch.from_numpy(v) if k == "patches" else torch.from_numpy(v).long()
          for k, v in batch.items()}
    loss, grads = steps.value_and_grad(model, tb)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    got = to_jax_layout(cfg, grads)
    assert float(np.abs(got["patch_proj/w"]).max()) > 0
    _check_grads(got, jgrads, *GRAD_TOL["float32"])


def test_pixtral_without_patches_gives_patch_proj_zeros():
    """A batch without "patches" never reaches ``patch_proj``: its gradient
    is zeros, as ``jax.grad`` gives it, and every other leaf matches."""
    jcfg = jreduced_config("pixtral-12b", compute_dtype="float32")
    cfg = reduced_config("pixtral-12b", compute_dtype="float32")
    batch = _batch(cfg.vocab_size, seed=10)
    jparams, jloss, jgrads = _reference(jcfg, batch)
    loss, grads = _port_grads(from_jax_params(cfg, flatten(jparams), device="cpu"), batch)
    assert loss == pytest.approx(jloss, rel=1e-5)
    got = to_jax_layout(cfg, grads)
    assert not np.asarray(jgrads["patch_proj/w"]).any()
    assert not got["patch_proj/w"].any()
    _check_grads({k: v for k, v in got.items() if k != "patch_proj/w"},
                 {k: v for k, v in jgrads.items() if k != "patch_proj/w"},
                 *GRAD_TOL["float32"])


def test_unreached_parameter_raises():
    """Any parameter the forward does not reach, other than the vision
    stub's ``patch_proj`` without patches, makes the gradient raise rather
    than take zeros (a block wired wrongly must not train silently)."""
    cfg = reduced_config("yi-34b", compute_dtype="float32")
    model = tmodel.init_params(cfg, 0, "cpu")
    model.register_parameter("stray", torch.nn.Parameter(torch.zeros(3)))
    with pytest.raises(RuntimeError, match="not have been used"):
        _port_grads(model, _batch(cfg.vocab_size))


@pytest.mark.parametrize("arch,n_layers", [(arch, None) for arch in ARCHS] + [("yi-34b", 9)])
def test_remat_gradients_equal_bit_for_bit(arch, n_layers):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if n_layers:
        kw.update(n_layers=n_layers)   # 9 repetitions: the two-level split
    cfg = reduced_config(arch, **kw)
    model = tmodel.init_params(cfg, 0, "cpu")
    batch = _batch(cfg.vocab_size, seed=3)
    l1, g1 = _port_grads(model, batch, remat=True)
    l0, g0 = _port_grads(model, batch, remat=False)
    assert l1 == l0
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_nine_layers_match_reference():
    """The two-level remat split at nine layers gives the reference's loss
    and gradients."""
    jcfg = jreduced_config("yi-34b", compute_dtype="float32", n_layers=9)
    cfg = reduced_config("yi-34b", compute_dtype="float32", n_layers=9)
    batch = _batch(cfg.vocab_size, seed=4)
    jparams, jloss, jgrads = _reference(jcfg, batch)
    loss, grads = _port_grads(from_jax_params(cfg, flatten(jparams), device="cpu"), batch)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _check_grads(to_jax_layout(cfg, grads), jgrads, *GRAD_TOL["float32"])


def test_chunked_loss_over_several_chunks(monkeypatch):
    """Four loss chunks (LOSS_CHUNK cut to 4 in both packages for the test)
    give the reference's loss and gradients, and the port's own one-chunk
    loss."""
    jcfg = jreduced_config("yi-34b", compute_dtype="float32")
    cfg = reduced_config("yi-34b", compute_dtype="float32")
    batch = _batch(cfg.vocab_size, seed=5)
    model = from_jax_params(cfg, flatten(jinit_params(jcfg, 0)), device="cpu")
    one, _ = _port_grads(model, batch)
    monkeypatch.setattr(jmodel, "LOSS_CHUNK", 4)
    monkeypatch.setattr(tmodel, "LOSS_CHUNK", 4)
    jparams, jloss, jgrads = _reference(jcfg, batch)
    loss, grads = _port_grads(model, batch)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert loss == pytest.approx(one, rel=1e-6)
    _check_grads(to_jax_layout(cfg, grads), jgrads, *GRAD_TOL["float32"])


@pytest.mark.parametrize("seq", [tmodel.LOSS_CHUNK, 2 * tmodel.LOSS_CHUNK])
def test_loss_on_both_sides_of_one_chunk_matches_reference(seq):
    """At the default LOSS_CHUNK: one chunk, not checkpointed, at seq
    LOSS_CHUNK, and two checkpointed chunks at twice that give the
    reference's loss and gradients."""
    jcfg = jreduced_config("yi-34b", compute_dtype="float32")
    cfg = reduced_config("yi-34b", compute_dtype="float32")
    batch = _batch(cfg.vocab_size, seed=7, s=seq)
    jparams, jloss, jgrads = _reference(jcfg, batch)
    loss, grads = _port_grads(from_jax_params(cfg, flatten(jparams), device="cpu"), batch)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _check_grads(to_jax_layout(cfg, grads), jgrads, *GRAD_TOL["float32"])


@pytest.mark.parametrize("window", [0, 5])
def test_mha_chunks_under_autograd_match_reference(window):
    """``mha`` with q-chunks (each checkpointed under autograd): output and
    input gradients against the reference's chunked ``mha``."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 19, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 19, 2, 8)).astype(np.float32) for _ in range(2))
    ct = rng.standard_normal((2, 19, 4, 8)).astype(np.float32)

    def jf(q, k, v):
        return jnp.sum(jmha(q, k, v, window=window, q_chunk=8) * ct)

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = (mha(*ts, window=window, q_chunk=8) * torch.tensor(ct)).sum()
    tg = torch.autograd.grad(out, ts)
    assert float(out.detach()) == pytest.approx(float(jl), rel=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", list_archs())
def test_to_jax_params_inverts_from_jax_params(arch):
    kw = dict(param_dtype="float32")
    jcfg, cfg = jreduced_config(arch, **kw), reduced_config(arch, **kw)
    flat = flatten(jinit_params(jcfg, 0))
    back = to_jax_params(from_jax_params(cfg, flat, device="cpu"))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key


def test_bf16_parameters_refuse_numpy():
    """No longer refused: bf16 parameters go to numpy as ``V2`` holding the
    reference's bf16 bits, and come back from them bit for bit."""
    kw = dict(param_dtype="bfloat16")
    jcfg, cfg = jreduced_config("yi-34b", **kw), reduced_config("yi-34b", **kw)
    flat = flatten(jinit_params(jcfg, 0))
    model = from_jax_params(cfg, flat, device="cpu")
    back = to_jax_params(model)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert arr.dtype.name == "bfloat16" and back[key].dtype == np.dtype("V2"), key
        assert back[key].tobytes() == arr.tobytes(), key
    again = from_jax_params(cfg, back, device="cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert q.dtype == torch.bfloat16 and torch.equal(p.view(torch.int16),
                                                         q.view(torch.int16)), name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_track_reference(microbatches):
    """Ten train steps from the same parameters on the same batches: the
    losses agree to 1e-4 relative (fp32 compute)."""
    jcfg = jreduced_config("yi-34b", compute_dtype="float32")
    cfg = reduced_config("yi-34b", compute_dtype="float32")
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10)
    jopt, opt = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    data = SyntheticTokens(cfg.vocab_size, 4, S, seed=2)
    jstate = jsteps.init_state(jcfg, jopt, seed=0)
    model = from_jax_params(cfg, flatten(jstate["params"]), device="cpu")
    state = steps.state_for(model, opt)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, microbatches))
    step = steps.make_train_step(cfg, opt, microbatches)
    jl, tl = [], []
    for i in range(10):
        batch = data.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, _tbatch(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]          # it learns
    tree = steps.state_tree(state)
    assert int(tree["opt"]["step"]) == 10


def test_microbatches_must_split_evenly():
    cfg = reduced_config("yi-34b")
    opt = adamw.AdamWConfig()
    state = steps.init_state(cfg, opt, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(cfg, opt, 2)(state, _tbatch(_batch(cfg.vocab_size, b=3)))
