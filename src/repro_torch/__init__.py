"""PyTorch/CUDA port of the AutoAnalyzer framework for NVIDIA Hopper.

Mirrors the module layout of the JAX package ``repro`` so each counterpart
is found under the same name.  The analysis half (``core``, ``perfdbg``) is
a copy of the numpy modules with only their package imports renamed; the
workload half (``models``, ``kernels``, ``launch``) is rewritten in torch,
with attention in prefill running through a hand-written sm_90a CUDA kernel
(``kernels/flash_attention.py``).  Nothing here imports jax.
"""
__version__ = "0.1.0"
