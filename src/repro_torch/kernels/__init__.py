"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Importing this package compiles nothing and imports no GPU toolchain: a
kernel is built (``_build``) at its first launch on a CUDA tensor.
The ops are ``kernels.ops.{attention, wkv6, rglru_scan}``; the package does
not re-export the last two, whose names are those of the wrapper modules
``kernels.wkv6`` and ``kernels.rglru_scan``.
"""
from .ops import attention, attention_ref, rglru_scan_ref, wkv6_ref
from .ref import flash_attention_ref

__all__ = ["attention", "attention_ref", "flash_attention_ref",
           "rglru_scan_ref", "wkv6_ref"]
