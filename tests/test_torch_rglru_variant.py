"""K2's choice of kernel and its checks, on the host.

``rglru_scan.variant`` sends a (B, S, W) scan to the staged kernel
(``rglru_scan_staged_launch``: CTAs of 64 channels, a and b staged by TMA)
for S > 1 with W % 4 == 0, and to the simple kernel (``rglru_scan_fwd_launch``,
one thread per channel) otherwise, by shape alone.  ``check_inputs`` holds
the staged kernel's inputs to the 16-byte alignment its tensor maps need.
(``tests/test_torch_flash_variant.py`` checks every C entry's argtypes.)
"""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rglru_scan as k2  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

SOURCE = (_build.CSRC / "rglru_scan.cu").read_text()


@pytest.mark.parametrize("B,S,W,expected", [
    (2, 4096, 4096, "staged"), (1, 2, 4, "staged"), (3, 37, 100, "staged"),
    (3, 4097, 4100, "staged"), (2, 1, 4096, "simple"), (1, 1, 4, "simple"),
    (2, 300, 99, "simple"), (2, 4096, 4098, "simple"),
])
def test_variant_is_chosen_by_shape(B, S, W, expected):
    assert k2.variant(B, S, W) == expected


def test_recurrentgemma_prefill_is_staged_and_decode_simple():
    """The serving path's K2 shapes at recurrentgemma-9b's published width:
    the prefill (B=2, S=4096) on the staged kernel, every decode step (S=1)
    on the simple one (``chip_smoke.py`` checks the launches on the card)."""
    W = get_config("recurrentgemma-9b").rnn_width
    assert k2.variant(2, 4096, W) == "staged"
    assert k2.variant(2, 1, W) == "simple"
    assert k2.grid(2, W) == 2 * W // k2.CHANNELS_PER_CTA


def test_entries_and_tile_match_the_source():
    for entry in (*k2.ENTRIES.values(), "rglru_scan_staged_info"):
        assert f'extern "C" int {entry}(' in SOURCE
    tw = int(re.search(r"constexpr int TW = (\d+);", SOURCE).group(1))
    assert tw == k2.CHANNELS_PER_CTA
    assert k2.grid(3, 100) == 3 * -(-100 // tw)


def test_check_inputs_raises_on_a_misaligned_staged_input():
    buf = torch.zeros(1 * 4 * 8 + 1)
    a = buf[1:].view(1, 4, 8)          # contiguous, 4 bytes past a boundary
    ok = torch.zeros(1, 4, 8)
    assert a.data_ptr() % k2.ALIGN
    with pytest.raises(ValueError, match="16-byte boundary"):
        k2.check_inputs(a, ok, None)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k2.check_inputs(ok, a, None)
    k2.check_inputs(ok, ok, None)


def test_check_inputs_lets_the_simple_kernel_take_any_alignment():
    """The simple kernel reads floats one by one: at S = 1 an input 4 bytes
    past a boundary is taken."""
    buf = torch.zeros(2 * 1 * 8 + 1)
    a = buf[1:].view(2, 1, 8)
    assert k2.variant(2, 1, 8) == "simple"
    k2.check_inputs(a, a, torch.zeros(2, 8))


@pytest.mark.parametrize("bad,match", [
    (dict(a=torch.zeros(1, 4, 8, dtype=torch.bfloat16)), "float32"),
    (dict(b=torch.zeros(1, 4, 9)), "one shape"),
    (dict(h0=torch.zeros(2, 8)), "h0 has shape"),
    (dict(a=torch.zeros(1, 8, 4).transpose(1, 2)), "contiguous"),
])
def test_check_inputs_rejects_what_no_kernel_takes(bad, match):
    args = {**dict(a=torch.zeros(1, 4, 8), b=torch.zeros(1, 4, 8), h0=None), **bad}
    with pytest.raises((TypeError, ValueError), match=match):
        k2.check_inputs(args["a"], args["b"], args["h0"])


def test_wrapper_refuses_cpu_tensors():
    """On the host the wrapper raises; ``ops.rglru_scan`` takes the plain
    loop for CPU tensors instead."""
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.rglru_scan_kernel(a, a)
    assert k2.rglru_scan_kernel.launches_by_variant.keys() == {"staged", "simple"}
