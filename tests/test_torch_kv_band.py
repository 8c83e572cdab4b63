"""The sliding-window KV band of the port's ``mha`` against the JAX
package's, on the CPU.

With a causal ``window``, no ``k_len`` and more queries than one q-chunk,
the reference (``repro.models.layers.mha``) slices each chunk's keys and
values to the band ``(q_end - window - q_chunk, q_end)`` of
``min(window + q_chunk, Sk)`` positions, clamped into the sequence; its
switch ``REPRO_NO_KV_SLICE`` turns the slicing off.  The port takes the
same band and has no switch.  Its outputs and gradients agree with the
reference's either way, at the tolerances of ``tests/test_torch_attention.py``
(f32 1e-5, bf16 2e-2), and it scores only the band: its counted flops are
those of ``window + q_chunk`` keys per chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Sq > q_chunk + window and not a multiple of q_chunk: three chunks, the
# last one padded in the reference's scan
B, SQ, K, DH, WINDOW, Q_CHUNK = 2, 40, 2, 16, 8, 16


def _inputs(G, q_offset, seed=0):
    rng = np.random.default_rng(seed)
    sk = q_offset + SQ                   # keys up to the last query, no k_len
    return (rng.standard_normal((B, SQ, K * G, DH)).astype(np.float32),
            rng.standard_normal((B, sk, K, DH)).astype(np.float32),
            rng.standard_normal((B, sk, K, DH)).astype(np.float32))


@pytest.mark.parametrize("no_slice", [False, True], ids=["sliced", "REPRO_NO_KV_SLICE"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("q_offset", [0, 12])
def test_band_matches_the_reference(monkeypatch, q_offset, G, dtype, no_slice):
    if no_slice:
        monkeypatch.setenv("REPRO_NO_KV_SLICE", "1")
    else:
        monkeypatch.delenv("REPRO_NO_KV_SLICE", raising=False)
    arrays = _inputs(G, q_offset)
    kw = dict(causal=True, window=WINDOW, q_offset=q_offset, q_chunk=Q_CHUNK)
    want = jlayers.mha(*(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays), **kw)
    got = layers.mha(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, SQ, K * G, DH)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("q_offset", [0, 12])
def test_band_gradients_match_the_reference(q_offset):
    """Training differentiates through the band (each chunk checkpointed):
    the gradients of q, k and v are the reference's."""
    arrays = _inputs(4, q_offset, seed=1)
    kw = dict(causal=True, window=WINDOW, q_offset=q_offset, q_chunk=Q_CHUNK)
    want = jax.grad(lambda q, k, v: jnp.sum(jlayers.mha(q, k, v, **kw) ** 2),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (layers.mha(*ts, **kw) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL["float32"])


def _flops(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("q_offset", [0, 12])
def test_each_chunk_scores_only_its_band(q_offset):
    """QK^T and PV of every chunk run over ``min(window + q_chunk, Sk)``
    keys: 2 x 2 B H rows band dh flops per chunk of ``rows`` queries."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, q_offset))
    H, sk = q.shape[2], k.shape[1]
    band = min(WINDOW + Q_CHUNK, sk)
    rows = [min(Q_CHUNK, SQ - c) for c in range(0, SQ, Q_CHUNK)]
    got = _flops(lambda: layers.mha(q, k, v, causal=True, window=WINDOW,
                                    q_offset=q_offset, q_chunk=Q_CHUNK))
    assert got == sum(4 * B * H * r * band * DH for r in rows)
    # without a window (or with k_len) every chunk scores all Sk keys
    full = _flops(lambda: layers.mha(q, k, v, causal=True, q_offset=q_offset,
                                     q_chunk=Q_CHUNK))
    assert full == sum(4 * B * H * r * sk * DH for r in rows) > got


def test_one_chunk_scores_every_key():
    """At Sq <= q_chunk there is no band, as in the reference: the chunk
    scores all Sk keys under the window mask."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 0))
    got = _flops(lambda: layers.mha(q, k, v, causal=True, window=WINDOW, q_chunk=SQ))
    assert got == 4 * B * q.shape[2] * SQ * SQ * DH
