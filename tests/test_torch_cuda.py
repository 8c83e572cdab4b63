"""The port's kernels on the card against their plain versions.

Needs a CUDA card of compute capability >= 9.0 and ``nvcc``; skips
otherwise.  Imports no jax, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=40),
                                dict(causal=True, softcap=20.0)],
                         ids=["causal", "full", "window", "softcap"])
def test_flash_attention_matches_plain(card, kw, dh, dtype):
    g = torch.Generator(device=card).manual_seed(dh)
    B, S, H, K = 2, 150, 6, 2
    q, k, v = (torch.randn((B, S, n, dh), generator=g, device=card).to(dtype)
               for n in (H, K, K))
    before = fa.flash_attention.launches
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ops.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_wrapper_rejects_noncontiguous(card):
    q = torch.zeros(1, 16, 4, 32, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)
