"""Attention of the port against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX oracle
(``repro.kernels.ref.flash_attention_ref``), the Pallas kernel in interpret
mode (``repro.kernels.ops.attention``) and the model's jnp attention
(``repro.models.layers.mha``, with yi-34b's ``pad_heads=64``) and through
the port's plain versions.  Tolerances are those of the JAX package's
kernel tests: f32 1e-5, bf16 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SETTINGS = {"causal": dict(causal=True),
            "non-causal": dict(causal=False),
            "window": dict(causal=True, window=8),
            "softcap": dict(causal=True, softcap=5.0),
            "scale": dict(causal=True, scale=0.3)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_ref_matches_jax_ref(setting, dtype):
    q, k, v = _arrays(0, (3, 40, 16), (3, 40, 16), (3, 40, 16))
    kw = SETTINGS[setting]
    want = jref.flash_attention_ref(*(_jax(a, dtype) for a in (q, k, v)), **kw)
    got = ref.flash_attention_ref(*(_torch(a, dtype) for a in (q, k, v)), **kw)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("setting", ["causal", "window", "softcap"])
def test_ops_attention_matches_pallas_interpret(setting, G, dtype):
    """CPU tensors take the plain path; the JAX side runs the Pallas kernel
    in interpret mode with its GQA expansion."""
    B, S, K, dh = 2, 64, 2, 32
    q, k, v = _arrays(1, (B, S, K * G, dh), (B, S, K, dh), (B, S, K, dh))
    kw = SETTINGS[setting]
    want = jops.attention(*(_jax(a, dtype) for a in (q, k, v)),
                          interpret=True, **kw)
    got = ops.attention(*(_torch(a, dtype) for a in (q, k, v)), **kw)
    assert got.shape == (B, S, K * G, dh)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("setting", ["causal", "window", "softcap"])
def test_mha_without_padding_matches_padded_reference(setting, G, dtype):
    """The reference pads yi-34b's heads to ``pad_heads=64``; the port never
    pads, and the outputs agree.  ``q_chunk`` < S exercises the chunked
    path on both sides."""
    B, S, K, dh = 2, 40, 2, 16
    q, k, v = _arrays(2, (B, S, K * G, dh), (B, S, K, dh), (B, S, K, dh))
    kw = SETTINGS[setting]
    want = jlayers.mha(*(_jax(a, dtype) for a in (q, k, v)), q_chunk=16,
                       pad_heads=64, **kw)
    got = layers.mha(*(_torch(a, dtype) for a in (q, k, v)), q_chunk=16, **kw)
    assert got.shape == (B, S, K * G, dh)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_attention_matches_model_mha(dtype):
    """The kernel's plain path and the model's plain attention agree."""
    q, k, v = _arrays(3, (2, 48, 8, 16), (2, 48, 2, 16), (2, 48, 2, 16))
    got = ops.attention(*(_torch(a, dtype) for a in (q, k, v)), causal=True)
    want = layers.mha(*(_torch(a, dtype) for a in (q, k, v)), causal=True)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_len", [1, 7, 24])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_mha_decode_matches_jax(k_len, softcap, dtype):
    B, S_buf, K, G, dh = 2, 24, 2, 3, 16
    q, k, v = _arrays(4, (B, 1, K * G, dh), (B, S_buf, K, dh), (B, S_buf, K, dh))
    want = jlayers.mha_decode(*(_jax(a, dtype) for a in (q, k, v)),
                              k_len=jnp.asarray(k_len, jnp.int32),
                              softcap=softcap)
    got = layers.mha_decode(*(_torch(a, dtype) for a in (q, k, v)),
                            k_len=k_len, softcap=softcap)
    _close(got, want, dtype)


def test_decode_masks_keys_past_k_len():
    q, k, v = _arrays(5, (1, 1, 2, 16), (1, 10, 2, 16), (1, 10, 2, 16))
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    base = layers.mha_decode(q, k, v, k_len=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, 4:] = 100.0
    v2[:, 4:] = -100.0
    torch.testing.assert_close(layers.mha_decode(q, k2, v2, k_len=4), base)


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes only CUDA tensors; the plain path is chosen
    by ``ops.attention`` from the tensor's device, never as a fallback."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


def test_ops_attention_rejects_other_devices():
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        ops.attention(q, q, q)
