"""K1's choice of kernel and the C interfaces of the port's kernels, on the
host.

``flash_attention.variant`` picks the tensor-core kernel (``"wgmma"``,
``csrc/flash_attention_sm90.cu``) for bf16 at d_head 64, 128 and 256 and the
SIMT kernel (``csrc/flash_attention.cu``) otherwise, by dtype and head size
alone.  Every ``extern "C"`` entry point of ``csrc/*.cu`` is called through
ctypes with the ``argtypes`` its wrapper sets; a parameter whose kind
differs (a pointer passed as an int, a long long as an int) is not caught by
any compiler and corrupts the call silently on the card, so the parameter
lists are compared here, from the sources.
"""
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as k1  # noqa: E402
from repro_torch.kernels import rglru_scan as k2  # noqa: E402
from repro_torch.kernels import ssm_state_update as k4  # noqa: E402
from repro_torch.kernels import wkv6 as k3  # noqa: E402

WRAPPED = {**k1.C_ENTRIES, **k2.C_ENTRIES, **k3.C_ENTRIES, **k4.C_ENTRIES}
KIND_OF_CTYPE = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                 ctypes.c_longlong: "long long", ctypes.c_float: "float"}
ENTRY = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)\s*\{')


def _kind(param: str) -> str:
    """The kind of one C parameter declaration, e.g. ``const void* q``."""
    if "*" in param:
        return "pointer"
    ctype = " ".join(param.split()[:-1])   # drop the parameter's name
    return {"int": "int", "long long": "long long", "float": "float"}[ctype]


def _c_entries():
    """{name: (return type, [parameter kinds])} of every extern "C" function
    of the port's CUDA sources."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in ENTRY.findall(src.read_text()):
            out[name] = (ret, [_kind(p) for p in params.split(",")])
    return out


C_ENTRIES = _c_entries()


@pytest.mark.parametrize("dtype,dh,expected", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"), (torch.bfloat16, 64, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
])
def test_variant_is_chosen_by_dtype_and_head_size(dtype, dh, expected):
    assert k1.variant(dtype, dh) == expected


@pytest.mark.parametrize("arch", ["yi-34b", "recurrentgemma-9b", "whisper-large-v3"])
def test_serving_prefill_attention_takes_the_wgmma_kernel(arch):
    """The models that attend on the serving path, in bf16 at their published
    head size, go through the tensor-core kernel (``chip_smoke.py`` checks
    the launches on the card)."""
    assert k1.variant(torch.bfloat16, get_config(arch).d_head) == "wgmma"


def test_every_c_entry_has_a_wrapper():
    assert sorted(C_ENTRIES) == sorted(WRAPPED)
    assert {entry for _, entry in k1.ENTRIES.values()} == {
        "flash_attention_fwd", "flash_attention_sm90_fwd"}
    for source, entry in k1.ENTRIES.values():
        assert source in _build.SOURCES
        assert entry in (_build.CSRC / f"{source}.cu").read_text()


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_c_parameters_match_the_wrapper_argtypes(name):
    ret, params = C_ENTRIES[name]
    assert ret == "int"   # the cudaError_t the wrappers read with restype c_int
    assert [KIND_OF_CTYPE[t] for t in WRAPPED[name]] == params


def test_wkv6_value_columns_match_the_source():
    """``wkv6.grid`` (the smoke prints it) takes K3's value columns per CTA
    from the wrapper; the kernel from its source."""
    src = (_build.CSRC / "wkv6.cu").read_text()
    ev = int(re.search(r"constexpr int EV = (\d+);", src).group(1))
    assert ev == k3.VALUE_COLUMNS_PER_CTA
    assert k3.grid(4, 40, 64) == 4 * 40 * 64 // ev
