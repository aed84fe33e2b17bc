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
  blockwise cross-entropy;
- serving (``models.serving`` ``SlotServer``, ``cli.serve``): the
  continuous-batching ring engine behind an HTTP front door, which runs
  the einsum attention path (no kernel), as the JAX package's does;
- the launch path (``client``, ``driver``, ``executor``, ``cli.main``):
  the JAX package's control plane, its own copy, with a torch runtime
  that hands each rank the rendezvous ``train.init()`` joins.

The control plane imports no torch: ``resolve_device`` is imported at first
use, so ``python -S -m tony_tpu_torch.driver`` (no site-packages) starts
and no launcher process holds a CUDA context.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
