"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Importing this package compiles nothing and imports no GPU toolchain: a
kernel is built (``_build``) at its first launch on a CUDA tensor.
"""
from .ops import attention, attention_ref
from .ref import flash_attention_ref

__all__ = ["attention", "attention_ref", "flash_attention_ref"]
