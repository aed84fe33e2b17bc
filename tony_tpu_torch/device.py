"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: ``cuda`` when it is present, and an error
    when it is not — an entry point never carries on silently on the CPU.
    The CPU is taken only when the caller names it (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: tony_tpu_torch runs on the GPU unless the "
                "caller passes device='cpu' explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


__all__ = ["resolve_device"]
