"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Importing this package compiles nothing and imports no GPU toolchain: a
kernel is built (``_build``) at its first launch on a CUDA tensor.
The ops are ``kernels.ops.{attention, wkv6, rglru_scan, ssm_state_update}``;
the package does not re-export the last three, whose names are those of the
wrapper modules ``kernels.wkv6``, ``kernels.rglru_scan`` and
``kernels.ssm_state_update``.
"""
from .ops import (attention, attention_ref, rglru_scan_ref,
                  ssm_state_update_ref, wkv6_ref)
from .ref import flash_attention_ref

__all__ = ["attention", "attention_ref", "flash_attention_ref",
           "rglru_scan_ref", "ssm_state_update_ref", "wkv6_ref"]
