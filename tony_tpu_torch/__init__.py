"""PyTorch/CUDA port of the JAX package's model path, for NVIDIA Hopper
(H100).

A second package beside the JAX package, which is the reference:
this one runs the same functions in PyTorch with hand-written CUDA C++
kernels (``csrc/``) where the JAX package had Pallas kernels. It imports
``torch`` and never ``jax`` or anything of the JAX package.

Ported so far, for the flagship decoder-only transformer on one device:

- KV-cache generation (``models.generate``, ``examples.lm_generate``), with
  the flash forward kernel on the prefill and the split-KV flash-decode
  kernel on every decode step;
- training (``train``, ``data``, ``examples.lm_train``), with the flash
  forward kernel and the two flash backward kernels in every step, and the
  blockwise cross-entropy.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
