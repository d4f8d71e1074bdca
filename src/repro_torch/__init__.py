"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A sibling of the JAX package, mirroring its subpackages and module names.
It imports torch, numpy and the standard library, never jax and nothing of
``repro``.
"""
