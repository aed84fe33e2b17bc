"""PyTorch/CUDA port of the JAX package's model path, for NVIDIA Hopper
(H100).

A second package beside the JAX package, which is the reference:
this one runs the same functions in PyTorch with hand-written CUDA C++
kernels (``csrc/``) where the JAX package had Pallas kernels. It imports
``torch`` and never ``jax`` or anything of the JAX package.

Ported so far: KV-cache generation for the flagship decoder-only
transformer (``models.generate``), with the flash forward kernel on the
prefill and the split-KV flash-decode kernel on every decode step.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
